"""Training launcher: ``python -m repro_torch.launch.train [--arch <id>]``:
``yolov2-tiled`` (the paper's tiled CNN) or an LM id the registry resolves
(``stablelm-1.6b``, the default as in the reference's launcher,
``qwen2-7b``, ``codeqwen1.5-7b``, ``command-r-35b``, ``mamba2-780m``,
``mixtral-8x22b``, ``jamba-v0.1-52b``, ``deepseek-v3-671b``,
``qwen2-vl-2b``, ``whisper-medium``).

The tiled-CNN path of ``repro/launch/train.py``: plans a YOLOv2 prefix over
an n x n virtual tile grid, builds the trainer (deferred per-batch weight
aggregation, clipping, cosine/warmup schedule, optional ``--compress int8``
error feedback) and runs it under ``runtime.driver.run_training`` on seeded
synthetic batches - the reference's ``make_batch`` recipe, so both
launchers see the same data.  It runs on the card unless ``--device cpu``
is given.  ``--groups auto`` plans the grouping with the cost model on
``--hw-profile`` or, where given, the ``--cluster`` spec (which overrides
it), at ``--batch`` with ``--grad-accum`` microbatches; a heterogeneous
``--cluster`` (``pi3x3+jetson``) also balances the tile partition by the
devices' FLOPs, and a map that does not divide over ``--grid`` (416 on 3)
gets the near-even ragged split - both run the shape-specialised ragged
executor.  ``--schedule`` picks the executor (overlap: packed exchange and
the interior/boundary split, uniform groups only), ``--crossover`` a hybrid
plan's spatial->data switch (the per-microbatch batch must then divide by
grid^2), ``--pipeline`` a pipeline tail (``none``, ``auto`` or a stage
count; stages hold no BN layer, so with ``--no-batch-norm``, and
``--grad-accum`` microbatches stream through them), ``--wire-codec`` the
codec of every strip, reshard and hand-off (``int8`` or ``topk:<k>``:
stateless forward strips, error feedback on the backward's; the planner
prices the wire under it).

Elastic training (DESIGN.md §10), on both paths: ``--ckpt-dir`` saves a
checkpoint every ``--ckpt-every`` steps and at the last, ``--resume``
(``auto``, ``always``, ``never``) restores one, and ``--fault-schedule``
replays ``runtime.faults``' grammar (``drop:jetson@5,slow:0.2@8,fail@9,
ckpt-crash@10,corrupt@12``).  On the tiled path a device drop or add
replans the stack onto the changed cluster (``replan_stack``: a
homogeneous grid becomes a ClusterSpec of ``--hw-profile`` first; a drop
may name a profile or a flat grid index) and the run continues with the
live state; the LM path has no replan, so a drop there is fatal.
``--ckpt-dir`` has no default, unlike the reference's ``/tmp/repro_ckpt``:
with ``--resume auto`` a shared default directory would make every run
resume from (or fail on) another run's checkpoint of another geometry.

On ranks (``--dist``, under torchrun; ``--dist-backend nccl|gloo``), the
tiled path runs one block of the grid per process, as the reference runs
one tile per device: ``parallel/dist.py:init_tile_group`` joins the group
torchrun describes, ``launch/mesh.py:make_dist_tile_mesh`` gives this
rank's block, every rank draws the same seeded batches and params (rank
0's broadcast), the halo strips, BN sums and the batch-end gradient sum
cross ranks, and only rank 0 prints.  The slice is the uniform sync plan:
checkpoints and faults on ranks, and the plans ``fusion._dist_of``
refuses, are ROADMAP A.20.2, a captured step on ranks A.20.3, the LM on
ranks A.20.5::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch yolov2-tiled --grid 2 --input-hw 416 --depth 16 --groups 4 \
        --batch 8 --grad-accum 2 --optimizer sgd --steps 3 --dist

Where the reference jits the step (the tiled step, the step after a
replan, the LM step), the port captures it as a CUDA graph on the card
(``jit_step``: two eager warm steps, then one capture replayed every step;
``train/trainer.py:capture_train_step``) and runs it eagerly on the CPU; a
run ends with ``step: N CUDA graphs captured`` (or ``step: eager on cpu``).

LM mode (every LM id of the reference): the reduced config unless
``--full``, ``--seq`` x ``--batch`` tokens a step from
``data.synthetic.synth_batch`` (the reference's stream; Qwen2-VL's batch
also holds patch embeddings and M-RoPE streams, Whisper's ``--seq`` frames
and ``--seq`` / 4 tokens),
``--remat``, ``--grad-accum``, ``--optimizer``, under the same driver, the
step under ``parallel.api.sharding_ctx`` of ``--mesh``'s virtual mesh
(``local``: 1 x the cards; ``single`` / ``multi``: the reference's
production pod / two pods, whose axes the MoE dispatch reads).
"""
from __future__ import annotations

import argparse
import contextlib
import io

import numpy as np
import torch

TILED_ARCH = "yolov2-tiled"


def jit_step(train_step, device):
    """Where the reference jits the step: captured as a CUDA graph on the
    card (``train/trainer.py:capture_train_step``), the eager step on the
    CPU."""
    from repro_torch.train.trainer import capture_train_step

    if torch.device(device).type == "cuda":
        return capture_train_step(train_step, device)
    return train_step


def _resolve_groups(spec: str, n_layers: int):
    if spec in ("none", "0"):        # 0 = per-layer sync, like the example
        return None
    if spec == "auto":
        return "auto"
    from repro_torch.core.tiling import uniform_grouping

    return uniform_grouping(n_layers, int(spec))


def _resolve_crossover(spec: str):
    if spec == "none":
        return None
    if spec == "auto":
        return "auto"
    return int(spec)


def _resolve_pipeline(spec: str):
    if spec == "none":
        return None
    if spec == "auto":
        return "auto"
    try:
        return int(spec)   # check_pipeline_arg validates the count itself
    except ValueError:
        raise SystemExit(
            f"--pipeline must be 'none', 'auto', or a stage count; got {spec!r}"
        ) from None


def _add_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--arch", default="stablelm-1.6b",
                    help=f"'{TILED_ARCH}' or an LM id: 'stablelm-1.6b' (default, as the "
                         "reference's), 'qwen2-7b', 'codeqwen1.5-7b', 'command-r-35b', "
                         "'mamba2-780m', 'mixtral-8x22b', 'jamba-v0.1-52b', 'deepseek-v3-671b', "
                         "'qwen2-vl-2b' or 'whisper-medium'")
    ap.add_argument("--full", action="store_true", help="LM: the full published config")
    ap.add_argument("--mesh", choices=["local", "single", "multi"], default="local",
                    help="LM: the virtual mesh the step runs under - 'local' (1 x the "
                         "cards, 1 x 1 on the CPU), 'single' (one pod: data 16 x model 16) "
                         "or 'multi' (pod 2 x data 16 x model 16)")
    ap.add_argument("--seq", type=int, default=64, help="LM: tokens per sequence")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"],
                    help="LM: rematerialisation of each layer ('dots' saves the matmuls with no batch dim)")
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
                    help="grouping profile: 'none' (sync every layer), 'auto' (the "
                         "cost model's choice), or an int (uniform groups of that size)")
    ap.add_argument("--hw-profile", default="pi3-core",
                    help="hardware profile for --groups auto")
    ap.add_argument("--cluster", default=None,
                    help="cluster spec, e.g. 'pi3x4' or 'pi3x3+jetson' - <profile>[x<count>] "
                         "parts joined by '+', filling the tile grid row-major; overrides "
                         "--hw-profile, and a heterogeneous one balances the tile partition")
    ap.add_argument("--no-batch-norm", action="store_true",
                    help="build the YOLO stack without batch norm")
    ap.add_argument("--schedule", default="sync", choices=["sync", "overlap", "auto"],
                    help="executor schedule (overlap = packed halo exchange + "
                         "interior/boundary split; auto = overlap only when the device "
                         "can hide collectives and the modelled hidden term is non-trivial)")
    ap.add_argument("--crossover", default="none",
                    help="spatial->data crossover layer - 'none' (all spatial), 'auto' "
                         "(cost-model choice; joint with the grouping DP under --groups "
                         "auto), or a layer index N")
    ap.add_argument("--pipeline", default="none",
                    help="pipeline tail over tile subsets: 'none', 'auto' (the cost "
                         "model's choice) or a stage count; needs --groups auto, and BN "
                         "layers must stay out of the tail (see --no-batch-norm)")
    ap.add_argument("--wire-codec", default="none",
                    help="per-sample collective codec - 'none', 'int8' (blockwise absmax, "
                         "stateless on forward strips, error feedback on the backward's and "
                         "the reshard adjoint), or 'topk:<k>' (k a fraction 0<k<1 or a "
                         "count); the planner prices the wire under the same codec")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (none by default: no checkpoints; see the "
                         "module docstring)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", default="auto", choices=["auto", "always", "never"],
                    help="checkpoint resume policy: 'auto' restores the newest loadable "
                         "checkpoint in --ckpt-dir if one exists, 'always' requires one, "
                         "'never' starts fresh")
    ap.add_argument("--dist", action="store_true",
                    help="yolov2-tiled: one block of the tile grid per process over "
                         "torch.distributed; start under torchrun (see the module docstring)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="--dist: nccl (default on cuda; one rank a card) or gloo (default on "
                         "cpu; on cuda only when named: strips staged through host memory)")
    ap.add_argument("--fault-schedule", default=None,
                    help="fault-injection schedule (runtime.faults): comma-separated "
                         "'kind[:arg]@step' items.  Kinds: 'drop:<device>@N' (a device - a "
                         "profile name or a flat grid index - leaves at step N), "
                         "'add:<device>@N' (one joins), 'slow:<sec>@N' (step N stalls), "
                         "'fail@N' (step N raises; checkpoint restart), "
                         "'ckpt-crash[:count]@N' (the writer crashes count times mid-save), "
                         "'corrupt@N' (flip bytes in the latest checkpoint; needs "
                         "--ckpt-dir).  Drops and adds replan the tiled stack onto the "
                         "changed cluster")


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
    if not args.dist:
        return _train_tiled(args, None)
    from repro_torch.parallel.dist import init_tile_group

    refused = [f for f, on in (("--ckpt-dir", args.ckpt_dir), ("--fault-schedule",
                                                              args.fault_schedule)) if on]
    if refused:
        raise ValueError(f"{' and '.join(refused)} under --dist: checkpoints, faults and "
                         "replans on ranks are ROADMAP A.20.2")
    group = init_tile_group(args.device, args.dist_backend)
    quiet = contextlib.redirect_stdout(io.StringIO()) if group.rank else contextlib.nullcontext()
    try:
        with quiet:
            return _train_tiled(args, group)
    finally:
        torch.distributed.destroy_process_group()


def _train_tiled(args, group) -> int:
    """The tiled run: on the virtual mesh (``group`` None) or on this
    rank's block of the grid."""
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.fusion import plan_manifest
    from repro_torch.core.grouping import parse_cluster_spec
    from repro_torch.models.yolo import make_yolo_tiled_arch, yolov2_16_layers
    from repro_torch.runtime.driver import run_training
    from repro_torch.train.trainer import make_train_step

    n_layers = len(yolov2_16_layers()[: args.depth])
    cluster = (
        parse_cluster_spec(args.cluster, args.grid, args.grid)
        if args.cluster
        else None
    )
    mesh = None
    if group is not None:
        from repro_torch.launch.mesh import make_dist_tile_mesh

        mesh = make_dist_tile_mesh(args.grid, args.grid, group.device, group)
    arch = make_yolo_tiled_arch(
        input_hw=(args.input_hw, args.input_hw),
        depth=args.depth,
        n=args.grid,
        m=args.grid,
        groups=_resolve_groups(args.groups, n_layers),
        backend=args.backend,
        schedule=args.schedule,
        hw=cluster if cluster is not None else args.hw_profile,
        batch=args.batch,
        crossover=_resolve_crossover(args.crossover),
        pipeline=_resolve_pipeline(args.pipeline),
        microbatches=max(args.grad_accum, 1),
        wire_codec=args.wire_codec,
        batch_norm=not args.no_batch_norm,
        device=args.device,
        mesh=mesh,
    )
    plan = arch.plan
    print(f"plan: backend={plan.backend} schedule={plan.schedule} "
          f"grid={args.grid}x{args.grid} crossover={plan.crossover} "
          f"groups={[(g.start, g.end, g.mode) for g in plan.groups]}"
          + (f" stages={plan.stages}" if plan.stages else "")
          + (f" wire_codec={plan.wire_codec}" if plan.wire_codec != "none" else "")
          + f" optimizer={args.optimizer} device={arch.mesh.device}"
          + (f" dist={group.world} ranks={mesh.ranks[0]}x{mesh.ranks[1]} "
             f"backend={group.backend} captured=False" if group is not None else ""))
    print(f"partition: rows={plan.partition.row_bounds} cols={plan.partition.col_bounds} "
          f"uniform={plan.is_uniform}" + (f" cluster={args.cluster}" if args.cluster else ""))
    pcfg = ParallelConfig(grad_accum=args.grad_accum)
    tcfg = TrainConfig(
        lr=args.lr, optimizer=args.optimizer, steps=args.steps,
        ckpt_every=args.ckpt_every, seed=args.seed,
        grad_compression=None if args.compress == "none" else args.compress,
    )
    init_state, train_step = make_train_step(arch, pcfg, tcfg)
    make_batch = make_batch_fn(args.batch, args.input_hw, arch.target_shape(args.batch),
                               args.seed, arch.mesh.device)
    if group is None:
        replan = make_replan(arch, cluster, args.hw_profile, args.batch, pcfg, tcfg)
        step = jit_step(train_step, arch.mesh.device)
    else:   # a collective captured in a CUDA graph is ROADMAP A.20.3
        replan, step = None, train_step
    report = run_training(
        init_state=init_state,
        train_step=step,
        make_batch=make_batch,
        steps=args.steps,
        cfg=_driver_config(args),
        seed=args.seed,
        faults=_faults(args),
        replan=replan,
        plan=plan_manifest(arch.plan, cluster),
        device=arch.mesh.device,
    )
    _print_done(report, [step, *(replan.live["steps"] if replan else [])], arch.mesh.device)
    return 0


def make_replan(arch, cluster, hw_profile: str, batch: int, pcfg, tcfg):
    """The elastic replan callback of a tiled run: on a ``ClusterChange``
    drop or add the device on the live cluster (a homogeneous grid becomes
    ``hw_profile`` x n*m first), ``replan_stack`` the live plan onto it at
    ``batch``, build the arch on a new virtual mesh on the same device and
    its train step (captured anew on the card: ``jit_step``; the old graph
    goes with the old step's last reference), print the ``replan (...)``
    line, and return ``(step, plan manifest)``.  ``replan.live`` holds the
    live cluster and plan, and the steps the replans built.  A drop's device is a profile name or, all digits, a
    flat row-major grid index; a replan whose data tail the microbatch does
    not divide over the new tile count is planned all-spatial instead (both
    are ROADMAP C.7: the reference's launcher raises on either)."""
    from repro_torch.core.fusion import plan_manifest, replan_stack
    from repro_torch.core.grouping import add_device, drop_device, parse_cluster_spec
    from repro_torch.launch.mesh import make_tile_mesh
    from repro_torch.models.tiled_cnn import TiledCNNArch
    from repro_torch.train.trainer import make_train_step

    live = {"cluster": cluster, "plan": arch.plan, "steps": []}
    accum = max(pcfg.grad_accum, 1)

    def replan(ev):
        plan = live["plan"]
        cl = live["cluster"]
        if cl is None:
            cl = parse_cluster_spec(f"{hw_profile}x{plan.n * plan.m}", plan.n, plan.m)
        if ev.kind == "drop":
            cl = drop_device(cl, int(ev.device) if ev.device.isdigit() else ev.device)
        else:
            cl = add_device(cl, ev.device)
        new_plan = replan_stack(plan, cl, batch=batch)
        if new_plan.crossover is not None and (batch // accum) % (new_plan.n * new_plan.m):
            # a data tail splits each microbatch over the survivors' tiles,
            # which this batch does not divide (ROADMAP C.7): stay spatial
            new_plan = replan_stack(plan, cl, batch=batch, crossover=None)
        new_arch = TiledCNNArch(plan=new_plan,
                                mesh=make_tile_mesh(new_plan.n, new_plan.m, arch.mesh.device),
                                loss_local=arch.loss_local)
        _, new_step = make_train_step(new_arch, pcfg, tcfg)
        live.update(cluster=cl, plan=new_plan)
        print(f"replan ({ev.kind}:{ev.device}): grid={new_plan.n}x{new_plan.m} "
              f"rows={new_plan.partition.row_bounds} cols={new_plan.partition.col_bounds} "
              f"crossover={new_plan.crossover} "
              f"modes={[(g.start, g.end, g.mode) for g in new_plan.groups]}"
              + (f" stages={new_plan.stages}" if new_plan.stages else ""))
        live["steps"].append(jit_step(new_step, arch.mesh.device))
        return live["steps"][-1], plan_manifest(new_plan, cl)

    replan.live = live
    return replan


def _driver_config(args):
    from repro_torch.runtime.driver import DriverConfig

    return DriverConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        log_every=args.log_every, resume=args.resume)


def _faults(args):
    from repro_torch.runtime.faults import FaultInjector

    return FaultInjector(args.fault_schedule) if args.fault_schedule else None


def _print_done(report, steps: list, device) -> None:
    m = report.last_metrics or {}
    print(
        f"done: steps={report.steps_done} restarts={report.restarts} "
        f"replans={report.replans} stragglers={report.straggler_steps} "
        f"loss={m.get('loss', float('nan')):.4f} gnorm={m.get('grad_norm', 0):.3f}"
    )
    graphs = sum(getattr(s, "captured", False) for s in steps)
    print(f"step: {graphs} CUDA graphs captured" if torch.device(device).type == "cuda"
          else "step: eager on cpu")


def _run_lm(args) -> int:
    from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
    from repro_torch.data.synthetic import place, synth_batch
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.models.registry import get_arch
    from repro_torch.parallel.api import sharding_ctx
    from repro_torch.runtime.driver import run_training
    from repro_torch.train.trainer import make_train_step

    arch = get_arch(args.arch, reduced=not args.full, device=args.device)
    mesh = (make_local_mesh(device=arch.device) if args.mesh == "local"
            else make_production_mesh(multi_pod=(args.mesh == "multi"), device=arch.device))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    pcfg = ParallelConfig(grad_accum=args.grad_accum, remat=args.remat)
    tcfg = TrainConfig(
        lr=args.lr, optimizer=args.optimizer, steps=args.steps,
        ckpt_every=args.ckpt_every, seed=args.seed,
        grad_compression=None if args.compress == "none" else args.compress,
    )
    cfg = arch.cfg
    print(f"model: {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} heads={cfg.n_heads}/"
          f"{cfg.n_kv_heads} vocab={cfg.vocab} dtype={cfg.dtype} remat={pcfg.remat} "
          f"optimizer={tcfg.optimizer} device={arch.device} mesh={mesh.shape}")
    init_state, train_step = make_train_step(arch, pcfg, tcfg)
    specs = arch.input_specs(shape)

    def make_batch(step: int) -> dict:
        return place(synth_batch(specs, cfg, args.seed, step), arch.device)

    step = jit_step(train_step, arch.device)
    with sharding_ctx(mesh):
        report = run_training(
            init_state=init_state,
            train_step=step,
            make_batch=make_batch,
            steps=args.steps,
            cfg=_driver_config(args),
            seed=args.seed,
            faults=_faults(args),
            device=arch.device,
        )
    _print_done(report, [step], arch.device)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    _add_args(ap)
    args = ap.parse_args(argv)
    if args.arch != TILED_ARCH:
        if args.dist:
            raise ValueError(f"--dist trains {TILED_ARCH}; the LM's data and model axes on "
                             "process groups are ROADMAP A.20.5")
        return _run_lm(args)
    return _run_tiled(args)


if __name__ == "__main__":
    raise SystemExit(main())
