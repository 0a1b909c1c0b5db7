"""Serving launcher: ``python -m repro_torch.launch.serve --cnn [...]``.

The ``--cnn`` mode of ``repro/launch/serve.py``: builds a YOLOv2-prefix
plan over an n x m virtual tile grid, takes its forward-only twin, freezes
BN statistics on a calibration batch, warms the bucket ladder, then drives
a synthetic image workload through ``runtime.driver.run_serving`` and prints
latency percentiles, throughput, bucket census and cache counters.  It runs
on the card unless ``--device cpu`` is given.  LM serving is later work
(ROADMAP A.18).
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def _cnn_main(args) -> int:
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.runtime.driver import run_serving

    n, m = (int(v) for v in args.grid.split("x"))
    arch = make_yolo_tiled_arch(
        input_hw=(args.size, args.size), depth=args.depth, n=n, m=m,
        backend=args.backend, device=args.device,
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
        step_bound=args.step_bound_ms / 1e3,
    )
    t0 = time.monotonic()
    engine.warmup()
    print(f"warmup: {len(engine.buckets)} buckets prepared in "
          f"{time.monotonic() - t0:.2f}s (cache: {engine.cache.stats()})")

    per_tick = max(1, args.requests // max(1, args.ticks))

    def on_tick(t, eng):
        for _ in range(per_tick):
            if eng._rid < args.requests:
                eng.submit(rng.standard_normal((h, w, cin)).astype(np.float32))

    t0 = time.monotonic()
    report = run_serving(engine, ticks=args.ticks, on_tick=on_tick)
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
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cnn", action="store_true",
                    help="tiled-CNN image serving (the only mode the port has)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grid", default="2x2", help="tile grid n x m")
    ap.add_argument("--depth", type=int, default=6, help="YOLOv2 prefix depth")
    ap.add_argument("--size", type=int, default=64, help="input H=W")
    ap.add_argument("--backend", choices=("torch", "cuda"), default="cuda")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--budget-ms", type=float, default=1000.0)
    ap.add_argument("--step-bound-ms", type=float, default=50.0,
                    help="service time per dispatch the deadline policy plans with")
    ap.add_argument("--ticks", type=int, default=16)
    args = ap.parse_args(argv)
    if not args.cnn:
        ap.error("only --cnn serving is ported; LM serving is ROADMAP A.18")
    return _cnn_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
