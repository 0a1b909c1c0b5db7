"""Training launcher: ``python -m repro_torch.launch.train --arch yolov2-tiled``.

The tiled-CNN path of ``repro/launch/train.py``: plans a YOLOv2 prefix over
an n x n virtual tile grid, builds the trainer (deferred per-batch weight
aggregation, clipping, cosine/warmup schedule, optional ``--compress int8``
error feedback) and runs it under ``runtime.driver.run_training`` on seeded
synthetic batches - the reference's ``make_batch`` recipe, so both
launchers see the same data.  It runs on the card unless ``--device cpu``
is given.  Flags of the reference the port does not have yet raise naming
their ROADMAP item: ``--groups auto`` and ``--cluster`` (A.9), ``--schedule
overlap`` (A.10), ``--crossover`` (A.11), ``--pipeline`` (A.13),
``--wire-codec`` (A.14), ``--ckpt-dir`` and ``--fault-schedule`` (A.15);
the LM architectures are A.18.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

TILED_ARCH = "yolov2-tiled"


def _resolve_groups(spec: str, n_layers: int):
    if spec in ("none", "0"):        # 0 = per-layer sync, like the example
        return None
    if spec == "auto":
        return "auto"
    from repro_torch.core.tiling import uniform_grouping

    return uniform_grouping(n_layers, int(spec))


def _resolve_int_or_auto(spec: str):
    if spec == "none":
        return None
    return spec if spec == "auto" else int(spec)


def _add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arch", default=TILED_ARCH,
                    help=f"'{TILED_ARCH}' (the LM architectures are ROADMAP A.18)")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor", "sgd"])
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress", default="none", choices=["none", "int8"],
                    help="int8 error-feedback compression of the batch-end gradients")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grid", type=int, default=1, help="n=m tile grid")
    ap.add_argument("--input-hw", type=int, default=64, help="input H=W")
    ap.add_argument("--depth", type=int, default=8, help="YOLO prefix depth")
    ap.add_argument("--backend", default="cuda", choices=["torch", "cuda"],
                    help="conv compute path: 'cuda' runs the hand-written kernels "
                         "(their plain versions on --device cpu), 'torch' F.conv2d")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--groups", default="none",
                    help="grouping profile: 'none' (sync every layer) or an int "
                         "(uniform groups of that size); 'auto' is ROADMAP A.9")
    ap.add_argument("--no-batch-norm", action="store_true",
                    help="build the YOLO stack without batch norm")
    # the reference's flags the port does not plan yet (each raises)
    ap.add_argument("--schedule", default="sync", choices=["sync", "overlap", "auto"])
    ap.add_argument("--crossover", default="none")
    ap.add_argument("--pipeline", default="none")
    ap.add_argument("--wire-codec", default="none")
    ap.add_argument("--cluster", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fault-schedule", default=None)


def make_batch_fn(batch: int, input_hw: int, target_shape, seed: int, device):
    """The reference launcher's synthetic stream: for step s, numpy
    ``default_rng([seed, s])`` draws the images, then a target of
    ``0.05 * N(0, 1)``."""

    def make_batch(step: int) -> dict:
        rng = np.random.default_rng([seed, step])
        x = rng.standard_normal((batch, input_hw, input_hw, 3), np.float32)
        t = 0.05 * rng.standard_normal(target_shape, np.float32)
        return {"x": torch.from_numpy(x).to(device), "t": torch.from_numpy(t).to(device)}

    return make_batch


def _run_tiled(args) -> int:
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.models.yolo import make_yolo_tiled_arch, yolov2_16_layers
    from repro_torch.runtime.driver import DriverConfig, run_training
    from repro_torch.train.trainer import make_train_step

    n_layers = len(yolov2_16_layers()[: args.depth])
    arch = make_yolo_tiled_arch(
        input_hw=(args.input_hw, args.input_hw),
        depth=args.depth,
        n=args.grid,
        m=args.grid,
        groups=_resolve_groups(args.groups, n_layers),
        backend=args.backend,
        schedule=args.schedule,
        hw=args.cluster,
        crossover=_resolve_int_or_auto(args.crossover),
        pipeline=_resolve_int_or_auto(args.pipeline),
        wire_codec=args.wire_codec,
        batch_norm=not args.no_batch_norm,
        device=args.device,
    )
    plan = arch.plan
    print(f"plan: backend={plan.backend} schedule={plan.schedule} "
          f"grid={args.grid}x{args.grid} crossover={plan.crossover} "
          f"groups={[(g.start, g.end, g.mode) for g in plan.groups]} device={arch.mesh.device}")
    pcfg = ParallelConfig(grad_accum=args.grad_accum)
    tcfg = TrainConfig(
        lr=args.lr, optimizer=args.optimizer, steps=args.steps, seed=args.seed,
        grad_compression=None if args.compress == "none" else args.compress,
    )
    init_state, train_step = make_train_step(arch, pcfg, tcfg)
    make_batch = make_batch_fn(args.batch, args.input_hw, arch.target_shape(args.batch),
                               args.seed, arch.mesh.device)
    report = run_training(
        init_state=init_state,
        train_step=train_step,
        make_batch=make_batch,
        steps=args.steps,
        cfg=DriverConfig(ckpt_dir=args.ckpt_dir, log_every=args.log_every),
        seed=args.seed,
        faults=args.fault_schedule,
    )
    m = report.last_metrics or {}
    print(
        f"done: steps={report.steps_done} restarts={report.restarts} "
        f"stragglers={report.straggler_steps} "
        f"loss={m.get('loss', float('nan')):.4f} gnorm={m.get('grad_norm', 0):.3f}"
    )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    _add_args(ap)
    args = ap.parse_args(argv)
    if args.arch != TILED_ARCH:
        raise NotImplementedError(f"--arch {args.arch}: the LM side is ROADMAP A.18")
    return _run_tiled(args)


if __name__ == "__main__":
    raise SystemExit(main())
