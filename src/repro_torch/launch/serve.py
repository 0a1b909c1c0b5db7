"""Serving launcher: ``python -m repro_torch.launch.serve [--cnn] [...]``
(``repro/launch/serve.py``).  Both modes run on the card unless
``--device cpu`` is given.

LM (default): the slot engine (``serve/engine.py``; on the card its tick
and prefill decode through CUDA graphs, the counterpart of the reference's
jitted ``decode_fn``) on the reduced config
of ``--arch``, as the reference's ``_lm_main``: seeded params, ``--requests``
synthetic prompts of 4-11 tokens, greedy (or ``--temperature``) answers of
``--max-new`` tokens over ``--slots`` slots; prints each request's first
tokens and the tokens per second.  The default ``--arch`` is the
reference's, ``stablelm-1.6b``.  ``qwen2-vl-2b`` and ``whisper-medium`` serve
token prompts alone, as the reference's do (Whisper against zeroed cross
K/V: ROADMAP C.15).

``--cnn``: builds a YOLOv2-prefix
plan over an n x m virtual tile grid (``--groups auto``: the cost model's
grouping on ``--hw`` at the largest bucket; ``--schedule overlap`` the overlap
executor; ``--crossover auto|N`` a hybrid plan, whose every bucket must divide
by the tile count, e.g. ``--buckets 4 8`` on 2x2; ``--wire-codec int8|topk:<k>``
compresses every strip statelessly), takes its forward-only twin, freezes
BN statistics on a calibration batch, warms the bucket ladder (on the card:
one CUDA graph captured per bucket; on the CPU the eager step), then drives
a synthetic image workload through ``runtime.driver.run_serving`` and prints
latency percentiles, throughput, bucket census, cache counters and the
captured graphs' replays.  The
deadline policy plans with the cost model's step bound on ``--hw``.

``--cnn --dist`` (under torchrun; ``--dist-backend nccl|gloo``) serves on
ranks, one block of the grid a process: ``parallel/dist.py:init_tile_group``
joins the group, the arch is built on ``launch/mesh.py:make_dist_tile_mesh``,
rank 0 draws the params and freezes the BN statistics and broadcasts both,
every rank warms the ladder (under nccl each bucket captured with the
forward's collectives inside its graph; gloo serves the eager forward), and
rank 0 owns the queue - it submits the requests and runs ``run_serving``,
broadcasting each dispatch - while the others follow
(``CNNServeEngine.follow``).  Only rank 0 prints, the plan line ending
``dist=W ranks=RrxRc backend=... captured=True|False``::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve --cnn \
        --size 416 --depth 16 --dist
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import time

import numpy as np

from repro_torch.models.registry import ARCH_IDS


def _lm_main(args) -> int:
    from repro_torch.models.registry import get_arch
    from repro_torch.serve.engine import Request, ServeEngine

    arch = get_arch(args.arch, reduced=True, device=args.device)
    params = arch.init(args.seed)
    engine = ServeEngine(arch, params, batch=args.slots, max_seq=args.max_seq,
                         temperature=args.temperature, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(0, arch.cfg.vocab, size=plen).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new))

    t0 = time.monotonic()
    done = engine.run(max_ticks=args.requests * (args.max_new + 16))
    dt = time.monotonic() - t0
    toks = sum(len(r.out_tokens) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: prompt_len={len(r.prompt)} out={r.out_tokens[:8]}...")
    print(f"served {len(done)} requests, {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s) "
          f"on {arch.device}, arch {args.arch}")
    print(f"decode: {len(engine.graphs)} CUDA graphs captured (the tick and a prefill a slot), "
          f"replays {engine.replays}" if engine.capture else f"decode: eager on {arch.device}")
    return 0


def _cnn_main(args) -> int:
    if not args.dist:
        return _serve_cnn(args, None)
    from repro_torch.parallel.dist import init_tile_group

    group = init_tile_group(args.device, args.dist_backend)
    quiet = contextlib.redirect_stdout(io.StringIO()) if group.rank else contextlib.nullcontext()
    try:
        with quiet:
            return _serve_cnn(args, group)
    finally:
        import torch.distributed

        torch.distributed.destroy_process_group()


def _serve_cnn(args, group) -> int:
    """The tiled-CNN serve run: on the virtual mesh (``group`` None) or on
    this rank's block of the grid, rank 0 owning the queue."""
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.runtime.driver import run_serving

    n, m = (int(v) for v in args.grid.split("x"))
    mesh = None
    if group is not None:
        from repro_torch.launch.mesh import make_dist_tile_mesh

        mesh = make_dist_tile_mesh(n, m, group.device, group)
    arch = make_yolo_tiled_arch(
        input_hw=(args.size, args.size), depth=args.depth, n=n, m=m,
        groups="auto" if args.groups == "auto" else None,
        backend=args.backend, schedule=args.schedule, hw=args.hw, batch=max(args.buckets),
        crossover=args.crossover, wire_codec=args.wire_codec, device=args.device, mesh=mesh,
    )
    params = arch.init(args.seed)
    rng = np.random.default_rng(args.seed)
    h, w = arch.plan.input_hw
    cin = arch.plan.layers[0].in_channels
    calib = rng.standard_normal((max(args.buckets), h, w, cin)).astype(np.float32)
    engine = arch.make_serve_engine(
        params, calibration=calib,
        buckets=tuple(args.buckets),
        latency_budget=args.budget_ms / 1e3,
        hw=args.hw,
    )
    print(f"plan: schedule={arch.plan.schedule} crossover={arch.plan.crossover} "
          f"modes={[g.mode for g in arch.plan.groups]}"
          + (f" wire_codec={arch.plan.wire_codec}" if arch.plan.wire_codec != "none" else "")
          + (f" dist={group.world} ranks={mesh.ranks[0]}x{mesh.ranks[1]} "
             f"backend={group.backend} captured={engine.capture}" if group is not None else ""))
    print(f"plan: groups={[(g.start, g.end) for g in arch.plan.groups]} "
          f"modeled step bound {engine.step_bound * 1e3:.3f} ms (hw={args.hw or 'pi3-core'})")
    t0 = time.monotonic()
    engine.warmup()
    print(f"warmup: {len(engine.buckets)} buckets prepared in "
          f"{time.monotonic() - t0:.2f}s (cache: {engine.cache.stats()})")
    cap = engine.stats()["capture"]
    if engine.capture:
        print(f"warmup: captured buckets {cap['buckets']}, graph pool bytes {cap['pool_bytes']}")
    else:
        print(f"warmup: eager step on {arch.mesh.device} (no capture"
              + (f"; {cap['mode']})" if group is not None else ")"))
    if not engine.leader:
        engine.follow()
        return 0

    per_tick = max(1, args.requests // max(1, args.ticks))

    def on_tick(t, eng):
        for _ in range(per_tick):
            if eng._rid < args.requests:
                eng.submit(rng.standard_normal((h, w, cin)).astype(np.float32))

    t0 = time.monotonic()
    try:
        report = run_serving(engine, ticks=args.ticks, on_tick=on_tick)
    finally:
        engine.finish()
    dt = time.monotonic() - t0
    print(f"served {report.served} requests in {dt:.2f}s "
          f"over {report.dispatches} dispatches on {arch.mesh.device}")
    if report.p50_s is not None:
        print(f"latency p50={report.p50_s*1e3:.1f}ms p99={report.p99_s*1e3:.1f}ms "
              f"throughput={report.throughput:.1f} img/s")
    print(f"bucket census: {report.bucket_census}  "
          f"deadline misses: {report.deadline_misses}  "
          f"min slack: {report.min_slack_s:+.3f}s")
    print(f"cache: {report.cache}")
    print(f"capture: {json.dumps(report.capture)}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cnn", action="store_true",
                    help="tiled-CNN image serving instead of the LM engine")
    ap.add_argument("--arch", choices=ARCH_IDS, default="stablelm-1.6b",
                    help="LM: 'stablelm-1.6b' (default), 'qwen2-7b', 'codeqwen1.5-7b', "
                         "'command-r-35b', 'mamba2-780m', 'mixtral-8x22b', 'jamba-v0.1-52b', "
                         "'deepseek-v3-671b', 'qwen2-vl-2b' or 'whisper-medium' (token prompts "
                         "alone: no patches, no audio)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    # --cnn mode
    ap.add_argument("--grid", default="2x2", help="tile grid n x m")
    ap.add_argument("--depth", type=int, default=6, help="YOLOv2 prefix depth")
    ap.add_argument("--size", type=int, default=64, help="input H=W")
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--schedule", choices=("sync", "overlap"), default="sync")
    ap.add_argument("--groups", choices=("none", "auto"), default="none")
    ap.add_argument("--crossover", default=None,
                    help="spatial->data crossover layer or 'auto'")
    ap.add_argument("--wire-codec", default="none",
                    help="strip codec: 'none', 'int8' or 'topk:<k>' (stateless forward)")
    ap.add_argument("--hw", default=None, help="hardware profile name")
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--budget-ms", type=float, default=1000.0)
    ap.add_argument("--ticks", type=int, default=16)
    ap.add_argument("--dist", action="store_true",
                    help="--cnn: one block of the tile grid per process over torch.distributed, "
                         "rank 0 owning the queue; start under torchrun (see the module docstring)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="--dist: nccl (default on cuda; one rank a card; buckets captured) or "
                         "gloo (default on cpu; on cuda only when named; the eager forward)")
    args = ap.parse_args(argv)
    if args.dist and not args.cnn:
        raise ValueError("--dist serves the tiled CNN (--cnn); the LM's axes on process groups "
                         "are ROADMAP A.20.5")
    if args.crossover is not None and args.crossover != "auto":
        args.crossover = int(args.crossover)
    return _cnn_main(args) if args.cnn else _lm_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
