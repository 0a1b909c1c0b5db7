#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card: ``nvidia-smi`` name and power limit;
2. build every CUDA kernel from this checkout's sources (``nvcc``, into
   ``build/repro_torch_kernels/``) and print ptxas' register report;
3. hold each kernel against its plain torch version on the card, TF32 off,
   at every per-tile shape the serve run gives it plus edge cases, and time
   kernel, plain version and the library call at the serve run's shapes;
4. serve full-width YOLOv2-16 at 416x416 on a 2x2 virtual tile grid
   through the CUDA kernel: freeze BN on a seeded calibration batch, warm
   the (1, 2, 4, 8) bucket ladder, drive 32 requests through
   ``run_serving``, check every response against the untiled plain
   reference and the launch count against 12 convs x dispatches.

The last line is the contract's ``{"ok": true, "device": {...}}``; the
``{"kernels": [...]}`` line and the serve metrics come before it.  Needs
one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
INPUT_HW = (416, 416)
GRID = (2, 2)
BUCKETS = (1, 2, 4, 8)
ARRIVALS = (8, 5, 3, 8, 2, 1, 5)     # requests per tick: 32 in all
N_CONVS = 12                         # conv layers of the 16-layer prefix
# Published peaks of one H100 SXM at 700 W (NVIDIA data sheet): fp32 on CUDA
# cores, and HBM3 bandwidth.
FP32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
TOL_FP32 = dict(atol=2e-5, rtol=1e-4)      # tests/test_kernels.py:22-23
TOL_BF16 = dict(atol=2e-3, rtol=2e-2)
# End to end, 12 fp32 convs whose sums run in another order in the kernel
# than in cuDNN, each followed by BN; the per-layer bar is TOL_FP32 above.
TOL_SERVE = dict(atol=1e-4, rtol=1e-4)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def err_stats(got, want, atol: float, rtol: float) -> tuple[float, float]:
    """(max |got - want|, max |got - want| / (atol + rtol |want|)); the
    second is <= 1 exactly when torch.testing-style closeness holds."""
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d / (atol + rtol * want.float().abs())).max())


def time_ms(fn, reps: int = 5, iters: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls,
    by CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / iters)
    return statistics.median(out)


def conv_shapes(plan, batch: int) -> list[dict]:
    """Per-layer conv shapes the tiled executor hands the backend for a
    batch of ``batch`` images: all n*m tiles in one call, each input carrying
    the halo present at that layer."""
    out = []
    tiles = plan.n * plan.m * batch
    for gi, g in enumerate(plan.groups):
        halo = plan.group_halos[gi]
        for l in g.layers:
            layer = plan.layers[l]
            sh, sw = plan.shard_hw[l]
            if not layer.pool:
                out.append(dict(
                    layer=l, stride=layer.stride,
                    x=(tiles, sh + halo[0] + halo[1], sw + halo[2] + halo[3], layer.in_channels),
                    w=(layer.kernel, layer.kernel, layer.in_channels, layer.out_channels),
                ))
            halo = plan.rem_halos[l]
    return out


def bound(x_shape, w_shape, stride: int, itemsize: int = 4) -> tuple[float, str]:
    """Least time (ms) the card could take for one conv: the larger of its
    fp32 operations over the CUDA-core peak and its bytes (each input read
    once, the output written once) over HBM bandwidth."""
    n, h, w, cin = x_shape
    k, _, _, cout = w_shape
    oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    flops = 2 * n * oh * ow * cout * k * k * cin
    nbytes = itemsize * (n * h * w * cin + k * k * cin * cout + cout + n * oh * ow * cout)
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core.spatial import stack_reference
    from repro_torch.core.tiling import Group
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d_tiled.kernel import conv2d_tile
    from repro_torch.kernels.conv2d_tiled.ref import conv2d_ref
    from repro_torch.models.yolo import make_yolo_tiled_arch
    from repro_torch.runtime.driver import run_serving

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.monotonic()
    libs = _build.build()
    print(f"built {sorted(libs)} in {time.monotonic() - t0:.1f}s")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    # -- 3. kernel against its plain version ----------------------------------
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    groups = [Group(0, 3), Group(4, 7), Group(8, 11), Group(12, 15)]
    arch = make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                groups=groups, backend="cuda", device=dev)
    plan = arch.plan
    check(list(plan.group_halos) == [(3, 3, 3, 3)] + [(2, 2, 2, 2)] * 3,
          f"group halos {plan.group_halos}")
    shapes = conv_shapes(plan, max(BUCKETS))
    check(len(shapes) == N_CONVS, f"{len(shapes)} conv shapes")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(x_shape, w_shape, bias, x_dtype=torch.float32, w_dtype=torch.float32):
        out_dtype = torch.promote_types(x_dtype, w_dtype)
        x = torch.randn(x_shape, generator=gen, device=dev).to(x_dtype)
        fan_in = w_shape[0] * w_shape[1] * w_shape[2]
        w = (torch.randn(w_shape, generator=gen, device=dev) * (2.0 / fan_in) ** 0.5).to(w_dtype)
        b = torch.randn(w_shape[-1], generator=gen, device=dev).to(out_dtype) if bias else \
            torch.zeros(w_shape[-1], device=dev, dtype=out_dtype)
        return x, w, b

    rows, serve_err = [], 0.0
    for s in shapes:
        x, w, b = inputs(s["x"], s["w"], bias=False)      # the serve path: zero bias, linear
        got = conv2d_tile(x, w, b, stride=s["stride"])
        want = conv2d_ref(x, w, b, stride=s["stride"])
        torch.cuda.synchronize()
        err, ratio = err_stats(got, want, **TOL_FP32)
        check(ratio <= 1.0, f"layer {s['layer']} {s['x']}x{s['w']}: max err {err} over tolerance")
        serve_err = max(serve_err, err)
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        k_ms = time_ms(lambda: conv2d_tile(x, w, b, stride=s["stride"]))
        p_ms = time_ms(lambda: conv2d_ref(x, w, b, stride=s["stride"]))
        l_ms = time_ms(lambda: F.conv2d(xn, wn, stride=s["stride"]))
        b_ms, b_by = bound(s["x"], s["w"], s["stride"])
        rows.append(dict(layer=s["layer"], x=s["x"], w=s["w"], max_abs_err=err,
                         ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by))
        print(f"  conv layer {s['layer']:2d} x{s['x']} w{s['w']}: err {err:.2e} "
              f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms cudnn {l_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})")
        del x, w, b, got, want

    f32, bf16 = torch.float32, torch.bfloat16
    extra = [
        # name, x shape, w shape, stride, act, bias, x dtype, w dtype
        ("stride2", (4, 33, 33, 16), (3, 3, 16, 32), 2, "linear", False, f32, f32),
        ("relu", (4, 20, 20, 32), (3, 3, 32, 40), 1, "relu", True, f32, f32),
        ("leaky", (4, 20, 20, 32), (3, 3, 32, 40), 1, "leaky", True, f32, f32),
        ("bias", (2, 18, 18, 64), (1, 1, 64, 96), 1, "linear", True, f32, f32),
        ("bf16", (4, 30, 30, 128), (3, 3, 128, 256), 1, "leaky", True, bf16, bf16),
        ("bf16_x_fp32_w", (4, 30, 30, 128), (3, 3, 128, 256), 1, "leaky", True, bf16, f32),
        ("fp32_x_bf16_w", (4, 30, 30, 128), (3, 3, 128, 256), 1, "relu", False, f32, bf16),
        ("cout1", (2, 17, 17, 24), (3, 3, 24, 1), 1, "relu", True, f32, f32),
        ("odd_cin", (3, 19, 23, 5), (3, 3, 5, 70), 2, "leaky", True, f32, f32),
    ]
    for name, xs, ws, stride, act, bias, x_dtype, w_dtype in extra:
        x, w, b = inputs(xs, ws, bias, x_dtype, w_dtype)
        got = conv2d_tile(x, w, b if bias else None, stride=stride, act=act)
        want = conv2d_ref(x, w, b if bias else None, stride=stride, act=act)
        torch.cuda.synchronize()
        check(got.dtype == want.dtype == torch.promote_types(x_dtype, w_dtype)
              and got.shape == want.shape, f"{name}: {got.dtype} {got.shape}")
        tol = TOL_BF16 if got.dtype == bf16 else TOL_FP32
        err, ratio = err_stats(got, want, **tol)
        check(ratio <= 1.0, f"case {name}: max err {err} over tolerance {tol}")
        print(f"  case {name}: out {got.dtype}, max err {err:.2e} "
              f"({ratio:.3f} of tolerance {tol}), max |out| {float(want.float().abs().max()):.3g}")
    print(f"kernel checks passed (fp32 {TOL_FP32}, bf16 {TOL_BF16})")

    # -- 4. serve ------------------------------------------------------------
    rng = np.random.default_rng(SEED)
    params = arch.init(SEED)
    calib = rng.standard_normal((8, *INPUT_HW, 3)).astype(np.float32)
    images = rng.standard_normal((sum(ARRIVALS), *INPUT_HW, 3)).astype(np.float32)
    sparams = arch.serve_params(params, calib)

    # The forward alone (device time, CUDA events) and the service time the
    # deadline policy plans with: a whole bucket-8 dispatch on the host
    # clock, host->device copy and device->host copy of the result included.
    from repro_torch.core.fusion import make_tiled_infer

    infer = make_tiled_infer(arch.serve_plan(), arch.mesh)
    x8 = torch.from_numpy(images[:8]).to(dev)
    fwd_ms = time_ms(lambda: infer(sparams, x8), reps=3, iters=3)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        infer(sparams, torch.from_numpy(images[:8]).to(dev)).cpu().numpy()
        walls.append(time.perf_counter() - t0)
    step_s = statistics.median(walls)
    print(f"bucket-8 forward {fwd_ms:.3f} ms (CUDA events); whole dispatch "
          f"{step_s * 1e3:.3f} ms (host clock, copies included)")

    # where the device time of a bucket-8 forward goes, by kernel name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            infer(sparams, x8)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    by_name = {}
    for e in prof.key_averages():
        # device-side events only (kernels, copies, fills): the host ops
        # that launch them report the same time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / 3
    dev_ms = sum(by_name.values())
    conv_ms = sum(v for k, v in by_name.items() if "conv2d_tile_kernel" in k)
    check(dev_ms > 0 and conv_ms > 0, "profiler saw no device time for the conv kernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(json.dumps({"profile_bucket8": {
        "wall_ms": prof_wall_ms, "device_ms": dev_ms, "conv_kernel_ms": conv_ms,
        "idle_share": max(0.0, 1 - dev_ms / prof_wall_ms),
        "top": [[k[:80], v] for k, v in top],
    }}))

    engine = arch.make_serve_engine(
        sparams, buckets=BUCKETS, step_bound=step_s,
        latency_budget=2.0 * step_s,   # headroom of 2 steps: every tick ships
    )
    warm = engine.warmup()
    check(warm["misses"] == len(BUCKETS), f"warmup misses {warm['misses']}")

    it = iter(images)

    def on_tick(t, eng):
        for _ in range(ARRIVALS[t]):
            eng.submit(next(it))

    conv2d_tile.launches = 0
    report = run_serving(engine, ticks=len(ARRIVALS), on_tick=on_tick)
    launches = conv2d_tile.launches
    print(f"served {report.served} in {report.dispatches} dispatches, census "
          f"{report.bucket_census}, launches {launches}, cache {report.cache}")
    check(report.served == len(images), f"served {report.served}")
    check(launches == N_CONVS * report.dispatches and launches > 0,
          f"launches {launches} != {N_CONVS} x {report.dispatches} dispatches")
    check(report.cache["misses"] == len(BUCKETS), f"cache misses {report.cache['misses']}")

    with torch.inference_mode():
        ref = torch.cat([
            stack_reference(torch.from_numpy(images[i:i + 8]).to(dev), sparams,
                            plan.layers, inference=True).cpu()
            for i in range(0, len(images), 8)
        ])
    got = torch.from_numpy(np.stack([r.result for r in sorted(engine.finished, key=lambda r: r.rid)]))
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()), f"output {tuple(got.shape)}")
    e2e_err, e2e_ratio = err_stats(got, ref, **TOL_SERVE)
    print(f"serve output {tuple(got.shape)} vs untiled plain reference: max err {e2e_err:.3e} "
          f"({e2e_ratio:.3f} of tolerance {TOL_SERVE})")
    check(e2e_ratio <= 1.0, "serve responses disagree with the untiled reference")

    kernel_ms = sum(r["ms"] for r in rows)
    bound_ms = sum(r["bound_ms"] for r in rows)
    ops_ms = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    print(json.dumps({"conv_shapes": rows}))
    print(json.dumps({"serve": {
        "p50_ms": report.p50_s * 1e3, "p99_ms": report.p99_s * 1e3,
        "img_per_s": report.throughput, "dispatches": report.dispatches,
        "bucket_census": report.bucket_census, "deadline_misses": report.deadline_misses,
        "bucket8_forward_ms": fwd_ms, "bucket8_dispatch_ms": step_s * 1e3,
        "bucket8_kernel_ms": kernel_ms, "max_abs_err": e2e_err,
        "card": smi,
    }}))
    print(json.dumps({"kernels": [{
        "name": "conv2d_tile",
        "route": "cuda",
        "source": "src/repro_torch/kernels/conv2d_tiled/csrc/conv2d_tile.cu",
        "replaces": "src/repro/kernels/conv2d_tiled/kernel.py:140",
        "launches": launches,
        "max_abs_err": serve_err,
        "ms": kernel_ms,
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bound_ms - ops_ms else "bytes",
        "library_ms": sum(r["library_ms"] for r in rows),
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
