#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card: ``nvidia-smi`` name and power limit;
2. build every CUDA kernel from this checkout's sources (``nvcc``, into
   ``build/repro_torch_kernels/``) and print ptxas' register report;
3. hold each kernel against its plain torch version on the card, TF32 off,
   at every per-tile shape its run gives it plus edge cases (stride 2,
   ragged, Cout=1, odd Cin, bf16 and mixed precision), and time kernel,
   plain version and the library call at those shapes: the forward (B1) at
   the serve run's bucket-8 shapes, dgrad (B2) and wgrad (B3) at the
   training run's microbatch-4 shapes;
4. serve full-width YOLOv2-16 at 416x416 on a 2x2 virtual tile grid
   through the CUDA kernel: freeze BN on a seeded calibration batch, warm
   the (1, 2, 4, 8) bucket ladder, drive 32 requests through
   ``run_serving``, check every response against the untiled plain
   reference and the launch count against 12 convs x dispatches;
5. train the same network (BN on, fp32) on the same grid through all three
   kernels: global batch 8 in 2 microbatches, Darknet's SGD at lr 1e-3,
   the launcher's seeded batches, 3 steps through ``make_train_step`` and
   ``run_training`` (no warmup, so every step moves the params).  Checks
   the run's launch counts against the code (12 B1, 11 B2 - the image
   input needs no dgrad - and 12 B3 per microbatch), ``restarts`` 0 and
   finite losses; then the gradients the run's own step 1 handed its
   update, against the untiled plain reference (cuDNN, TF32 off,
   autograd): the loss against its fp32 run, the gradients against its
   fp64 run (see ``GRAD_FLOOR_FACTOR``), and that the same check rejects a
   planted wgrad fault; then the params after the last step against the
   same trainer run on the torch backend in fp64.  Prints the
   ``{"train": ...}`` line and a profile of one step.

The last line is the contract's ``{"ok": true, "device": {...}}``; the
``{"kernels": [...]}`` line and the serve and train metrics come before it.
Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
# wgrad sums ~1e5-1e6 products per element, in another order than the plain
# version, so it is held normwise: max |got - want| <= WGRAD_NORM_TOL *
# max |want|.  The training gradients are held the same way, per leaf.
WGRAD_NORM_TOL = 1e-3
TRAIN_LOSS_RTOL = 1e-5
# The whole-step gradients of 16 BN layers under an L2 loss to a near-zero
# target are ill-conditioned in fp32: BN's backward cancels most of a
# cotangent that is nearly the layer's own normalised output, and the plain
# fp32 reference itself lands ~1e-2 (normwise, per leaf) from an fp64
# evaluation of the same step.  So step 1's grads are held against the fp64
# reference: per leaf within max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR x the
# plain fp32 reference's own error), i.e. no worse than twice what fp32 gives
# (measured: at most 1.05x on a leaf above the floor).  A wgrad that leaves
# out one tile must fail this check, and the script plants that fault to show
# it does.  The params after the last step are held the same way against an
# fp64 run of the trainer.  Distances from the fp32 reference are printed too.
GRAD_FLOOR_FACTOR = 2.0
TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS, TRAIN_LR = 8, 2, 3, 1e-3


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


def conv_flops(x_shape, w_shape, stride: int) -> int:
    """Multiply-adds x 2 of one VALID conv - the same for its dgrad and
    wgrad, which pair the same products differently."""
    n, h, w, cin = x_shape
    k, _, _, cout = w_shape
    oh, ow = (h - k) // stride + 1, (w - k) // stride + 1
    return 2 * n * oh * ow * cout * k * k * cin


def bound(flops: int, nbytes: int) -> tuple[float, str]:
    """Least time (ms) the card could take: the larger of the fp32
    operations over the CUDA-core peak and the bytes (each input read once,
    each output written once) over HBM bandwidth."""
    t_ops, t_bytes = flops / FP32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def out_shape(x_shape, w_shape, stride: int) -> tuple:
    n, h, w, _ = x_shape
    k = w_shape[0]
    return (n, (h - k) // stride + 1, (w - k) // stride + 1, w_shape[-1])


def kernel_entry(name, source, replaces, rows, launches, err):
    """One entry of the ``{"kernels": ...}`` line: ``rows`` are the per-shape
    timings of the run's shapes, summed."""
    b = sum(r["bound_ms"] for r in rows)
    ops = sum(r["bound_ms"] for r in rows if r["bound_by"] == "operations")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err,
        "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": b, "bound_by": "operations" if ops >= b - ops else "bytes",
        "library_ms": sum(r["library_ms"] for r in rows),
    }


def device_ms_by_name(prof, runs: int) -> dict:
    """Device time (ms per run) by kernel name from a profiler trace: device
    events only (kernels, copies, fills), since the host ops that launch
    them report the same time again."""
    import torch

    by_name = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3 / runs
    return by_name


def train_phase(dev, groups, smi: str) -> dict:
    """Phase 5: train YOLOv2-16 at 416x416 on the 2x2 grid through the three
    kernels.  Returns the launch count of each kernel in the training run."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch.kernels.conv2d_tiled.ops as conv_ops
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.fusion import make_deferred_grad_step, reference_loss
    from repro_torch.kernels.conv2d_tiled.kernel import (
        conv2d_dgrad_tile,
        conv2d_tile,
        conv2d_wgrad_tile,
    )
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.yolo import l2_loss_local, make_yolo_tiled_arch
    from repro_torch.optim.optimizers import make_optimizer, tree_leaves, tree_map
    from repro_torch.runtime.driver import DriverConfig, run_training
    from repro_torch.train.trainer import TrainState, make_train_step

    def make_arch(backend):
        return make_yolo_tiled_arch(input_hw=INPUT_HW, depth=16, n=GRID[0], m=GRID[1],
                                    groups=groups, backend=backend, device=dev)

    arch = make_arch("cuda")
    pcfg = ParallelConfig(grad_accum=TRAIN_ACCUM)
    tcfg = TrainConfig(lr=TRAIN_LR, optimizer="sgd", warmup=0, steps=TRAIN_STEPS, seed=SEED)
    step1 = {}      # the run's own step-1 loss and gradients, as its update sees them

    def on_grads(step, loss, grads):
        if step == 0 and not step1:
            step1.update(loss=loss, grads=tree_leaves(grads))

    init_state, train_step = make_train_step(arch, pcfg, tcfg, on_grads=on_grads)
    make_batch = make_batch_fn(TRAIN_BATCH, INPUT_HW[0], arch.target_shape(TRAIN_BATCH), SEED, dev)

    # the main path: make_train_step under run_training, counts from 0
    events, logged, last = [], [], {}

    def timed_step(state, batch):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, m = train_step(state, batch)
        b.record()
        events.append((a, b))
        logged.append(m)
        last["state"] = state
        return state, m

    kernels = {"conv2d_tile": conv2d_tile, "conv2d_dgrad_tile": conv2d_dgrad_tile,
               "conv2d_wgrad_tile": conv2d_wgrad_tile}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for f in kernels.values():
        f.launches = 0
    report = run_training(init_state=init_state, train_step=timed_step, make_batch=make_batch,
                          steps=TRAIN_STEPS, cfg=DriverConfig(), seed=SEED)
    launches = {name: f.launches for name, f in kernels.items()}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    step_ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(m["loss"]) for m in logged]
    gnorms = [float(m["grad_norm"]) for m in logged]
    micro = TRAIN_ACCUM * TRAIN_STEPS
    want = {"conv2d_tile": N_CONVS * micro, "conv2d_dgrad_tile": (N_CONVS - 1) * micro,
            "conv2d_wgrad_tile": N_CONVS * micro}
    print(f"trained {report.steps_done} steps, restarts {report.restarts}, launches {launches}")
    check(report.restarts == 0, f"restarts {report.restarts}")
    check(report.steps_done == TRAIN_STEPS and len(losses) == TRAIN_STEPS, "step count")
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)), f"losses {losses} gnorms {gnorms}")
    check(launches == want, f"launches {launches} != {want}")

    # Step 1 of the run against the untiled plain reference from the same
    # params and batch: per-microbatch forward (BN statistics per
    # microbatch, as the deferred step takes them), cuDNN with TF32 off,
    # autograd, in fp32 and in fp64.  The two microbatches have equal
    # counts, so the deferred loss is the mean of their losses.
    params0 = init_state(SEED).params
    names = [f"{i}.{k}" for i, p in enumerate(params0) for k in p]
    ref_plan = dataclasses.replace(arch.plan, backend="torch")

    def split(v):
        return v.reshape(TRAIN_ACCUM, v.shape[0] // TRAIN_ACCUM, *v.shape[1:])

    b0 = make_batch(0)

    def reference(dtype):
        live = [{k: v.detach().to(dtype).requires_grad_(True) for k, v in p.items()}
                for p in params0]
        loss = sum(reference_loss(live, xm.to(dtype), tm.to(dtype), ref_plan, l2_loss_local)
                   for xm, tm in zip(split(b0["x"]), split(b0["t"]))) / TRAIN_ACCUM
        grads = torch.autograd.grad(loss, tree_leaves(live))
        return float(loss.detach()), grads

    def normwise(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    ref_loss, ref32 = reference(torch.float32)
    _, ref64 = reference(torch.float64)
    plain64 = [normwise(a, b) for a, b in zip(ref32, ref64)]
    bars = [max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * p) for p in plain64]
    vs_plain = [normwise(a, b) for a, b in zip(step1["grads"], ref32)]
    tiled64 = [normwise(a, b) for a, b in zip(step1["grads"], ref64)]
    step1["loss"] = float(step1["loss"])
    loss_rel = abs(step1["loss"] - ref_loss) / abs(ref_loss)
    worst = max(range(len(names)), key=lambda i: tiled64[i] / bars[i])
    print(f"train step 1 vs untiled plain reference: loss {step1['loss']:.7g} vs {ref_loss:.7g} "
          f"(rel err {loss_rel:.2e}, bar {TRAIN_LOSS_RTOL}); grads vs the fp32 reference: max "
          f"normwise err {max(vs_plain):.2e}; vs fp64: tiled {max(tiled64):.2e}, plain fp32 "
          f"{max(plain64):.2e}; nearest its bar: {names[worst]} tiled {tiled64[worst]:.2e}, "
          f"plain {plain64[worst]:.2e}, {tiled64[worst] / bars[worst]:.2f} of its bar")
    check(step1["loss"] == losses[0], "on_grads saw another loss than the run logged")
    check(loss_rel <= TRAIN_LOSS_RTOL, f"step-1 loss rel err {loss_rel}")
    for n, t64, p64, bar in zip(names, tiled64, plain64, bars):
        check(t64 <= bar, f"step-1 grad {n}: normwise err {t64} vs fp64 over its bar {bar} "
              f"(plain fp32 reference {p64})")

    # The same check must reject a wrong backward: B3 leaving out one of the
    # 16 tile-images of a microbatch (tile (0, 0), image 0) fails it on
    # every conv filter.
    real_wgrad = conv_ops.conv2d_wgrad_tile

    def wgrad_dropping_one_tile(x, g, kernel, **kw):
        g = g.clone()
        g[0] = 0
        return real_wgrad(x, g, kernel, **kw)

    conv_ops.conv2d_wgrad_tile = wgrad_dropping_one_tile
    try:
        _, bad = make_deferred_grad_step(arch.plan, arch.mesh, l2_loss_local,
                                         microbatches=TRAIN_ACCUM)(
            params0, split(b0["x"]), split(b0["t"]))
    finally:
        conv_ops.conv2d_wgrad_tile = real_wgrad
    fault = {n: normwise(a, r) / bar for n, a, r, bar in zip(names, tree_leaves(bad), ref64, bars)
             if n.endswith(".w")}
    print(f"planted fault (B3 drops one tile): err / bar per conv filter, least "
          f"{min(fault.values()):.2f} ({min(fault, key=fault.get)})")
    check(len(fault) == N_CONVS and all(r > 1.0 for r in fault.values()),
          f"the step-1 grad check passed a wgrad that drops one tile: {fault}")
    del bad, ref32

    # The trainer tail (clipping, schedule, SGD momentum and weight decay,
    # the microbatch accumulation) on the card: the run's params after all
    # steps against the same trainer on the torch backend, in fp64 and in
    # fp32, on the same batches.  Each leaf's update (params after - before)
    # is held normwise to the fp64 run, within max(WGRAD_NORM_TOL,
    # GRAD_FLOOR_FACTOR x the fp32 run's own error).
    def trainer_run(dtype):
        init, step = make_train_step(make_arch("torch"), pcfg, tcfg)
        p = tree_map(lambda t: t.to(dtype), init(SEED).params)
        st = TrainState(p, make_optimizer(tcfg.optimizer).init(p), 0)
        out = []
        for s in range(TRAIN_STEPS):
            st, m = step(st, {k: v.to(dtype) for k, v in make_batch(s).items()})
            out.append(float(m["loss"]))
        return tree_leaves(st.params), out

    p0 = tree_leaves(params0)
    fin64, losses64 = trainer_run(torch.float64)
    fin32, _ = trainer_run(torch.float32)
    upd64 = [a.double() - b.double() for a, b in zip(fin64, p0)]

    def upd_err(fin):
        return [normwise(a.double() - b.double(), u) for a, b, u in zip(fin, p0, upd64)]

    tail = upd_err(tree_leaves(last["state"].params))
    tail32 = upd_err(fin32)
    tail_bars = [max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * e) for e in tail32]
    loss64_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses64))
    worst = max(range(len(names)), key=lambda i: tail[i] / tail_bars[i])
    print(f"params after {TRAIN_STEPS} steps vs the torch-backend trainer in fp64: update err max "
          f"{max(tail):.2e} (fp32 trainer {max(tail32):.2e}); nearest its bar: {names[worst]} "
          f"{tail[worst]:.2e}, {tail[worst] / tail_bars[worst]:.2f} of its bar; losses rel err "
          f"{loss64_rel:.2e}")
    check(loss64_rel <= TRAIN_LOSS_RTOL, f"losses {losses} vs fp64 trainer {losses64}")
    for n, e, bar in zip(names, tail, tail_bars):
        check(e <= bar, f"param update {n} after {TRAIN_STEPS} steps: normwise err {e} over {bar}")
    step1_out = {"loss_rel_err": loss_rel, "grad_err_vs_plain32": max(vs_plain),
                 "grad_err_vs_fp64": max(tiled64), "plain32_err_vs_fp64": max(plain64),
                 "per_leaf": {n: [a, b, c] for n, a, b, c in zip(names, vs_plain, tiled64, plain64)},
                 "planted_fault_err_over_bar": fault}
    after = {"update_err_vs_fp64": max(tail), "fp32_trainer_update_err_vs_fp64": max(tail32),
             "loss_rel_err_vs_fp64": loss64_rel,
             "per_leaf": {n: [a, b] for n, a, b in zip(names, tail, tail32)}}
    del fin64, fin32, upd64, ref64

    # where the device time of one step goes, by kernel name
    state = init_state(SEED)
    batch = make_batch(0)
    train_step(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batch)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_ms_by_name(prof, 1)
    dev_ms = sum(by_name.values())
    part = {name: sum(v for k, v in by_name.items() if key in k)
            for name, key in (("conv2d_tile", "conv2d_tile_kernel"),
                              ("conv2d_dgrad_tile", "conv2d_dgrad_kernel"),
                              ("conv2d_wgrad_tile", "conv2d_wgrad_"))}
    check(dev_ms > 0 and all(v > 0 for v in part.values()),
          f"profiler saw no device time for a kernel: {part}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({"profile_train_step": {
        "wall_ms": prof_wall_ms, "device_ms": dev_ms, "kernel_ms": part,
        "top": [[k[:80], v] for k, v in top],
    }}))
    med = statistics.median(step_ms)
    print(json.dumps({"train": {
        "steps": report.steps_done, "restarts": report.restarts,
        "global_batch": TRAIN_BATCH, "microbatches": TRAIN_ACCUM, "optimizer": "sgd",
        "lr": TRAIN_LR, "loss": losses, "grad_norm": gnorms,
        "step_ms_cuda_events": step_ms, "step_ms_cuda_events_median": med,
        "step_ms_host": [t * 1e3 for t in report.step_times],
        "step_ms_host_median": statistics.median(report.step_times) * 1e3,
        "img_per_s_cuda_events": TRAIN_BATCH / (med / 1e3),
        "peak_mem_bytes": peak, "launches": launches,
        "step1": step1_out, "after_steps": after,
        "card": smi,
    }}))
    return launches


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
    from repro_torch.kernels.conv2d_tiled.kernel import (
        conv2d_dgrad_tile,
        conv2d_tile,
        conv2d_wgrad_tile,
    )
    from repro_torch.kernels.conv2d_tiled.ref import (
        conv2d_dgrad_ref,
        conv2d_ref,
        conv2d_wgrad_ref,
    )
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
        y_shape = out_shape(s["x"], s["w"], s["stride"])
        b_ms, b_by = bound(conv_flops(s["x"], s["w"], s["stride"]), 4 * (
            math.prod(s["x"]) + math.prod(s["w"]) + s["w"][-1] + math.prod(y_shape)))
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
    print(f"B1 checks passed (fp32 {TOL_FP32}, bf16 {TOL_BF16})")

    # B2 / B3 at the training run's shapes: all 16 tiles of a microbatch of 4.
    # Layer 0's dgrad is checked but not on the path (its input is the image).
    def bwd_case(x_shape, w_shape, stride, x_dtype=f32, w_dtype=f32):
        x, w, _ = inputs(x_shape, w_shape, False, x_dtype, w_dtype)
        g_dtype = torch.promote_types(x_dtype, w_dtype)
        g = torch.randn(out_shape(x_shape, w_shape, stride), generator=gen, device=dev).to(g_dtype)
        hw, k = x_shape[1:3], w_shape[0]
        dx = conv2d_dgrad_tile(g, w, hw, stride=stride)
        dx_ref = conv2d_dgrad_ref(g, w, hw, stride)
        dw = conv2d_wgrad_tile(x, g, k, stride=stride, out_dtype=w_dtype)
        dw_ref = conv2d_wgrad_ref(x, g, k, stride, w_dtype)
        torch.cuda.synchronize()
        check(dx.dtype == dx_ref.dtype == g_dtype and dx.shape == dx_ref.shape == x.shape,
              f"dgrad {x_shape}x{w_shape}: {dx.dtype} {tuple(dx.shape)}")
        check(dw.dtype == dw_ref.dtype == w_dtype and dw.shape == dw_ref.shape == w.shape,
              f"wgrad {x_shape}x{w_shape}: {dw.dtype} {tuple(dw.shape)}")
        d_err, d_ratio = err_stats(dx, dx_ref, **(TOL_BF16 if g_dtype == bf16 else TOL_FP32))
        check(d_ratio <= 1.0, f"dgrad {x_shape}x{w_shape} s{stride}: max err {d_err} over tolerance")
        if w_dtype == bf16:
            w_err, w_ratio = err_stats(dw, dw_ref, **TOL_BF16)
        else:
            w_err = float((dw.float() - dw_ref.float()).abs().max())
            w_ratio = w_err / (WGRAD_NORM_TOL * float(dw_ref.float().abs().max()))
        check(w_ratio <= 1.0, f"wgrad {x_shape}x{w_shape} s{stride}: max err {w_err} over tolerance")
        return x, w, g, d_err, d_ratio, w_err, w_ratio

    dgrad_rows, wgrad_rows, dgrad_err, wgrad_err = [], [], 0.0, 0.0
    for s in conv_shapes(plan, TRAIN_BATCH // TRAIN_ACCUM):
        st, k, hw = s["stride"], s["w"][0], s["x"][1:3]
        x, w, g, d_err, d_ratio, w_err, w_ratio = bwd_case(s["x"], s["w"], st)
        xn, wn, gn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), g.permute(0, 3, 1, 2)
        flops = conv_flops(s["x"], s["w"], st)
        nbytes = 4 * (math.prod(s["x"]) + math.prod(s["w"]) + math.prod(g.shape))
        line = f"  bwd layer {s['layer']:2d} x{s['x']} w{s['w']}:"
        if s["layer"] != 0:
            dgrad_err = max(dgrad_err, d_err)
            b_ms, b_by = bound(flops, nbytes)
            # how close kernel and plain fp32 version each come to an fp64 dgrad
            dx64 = conv2d_dgrad_ref(g.double(), w.double(), hw, st)
            fp64_err = [float((d.double() - dx64).abs().max())
                        for d in (conv2d_dgrad_tile(g, w, hw, stride=st), conv2d_dgrad_ref(g, w, hw, st))]
            del dx64
            row = dict(layer=s["layer"], x=s["x"], w=s["w"], max_abs_err=d_err, err_ratio=d_ratio,
                       kernel_err_vs_fp64=fp64_err[0], plain_err_vs_fp64=fp64_err[1],
                       ms=time_ms(lambda: conv2d_dgrad_tile(g, w, hw, stride=st)),
                       plain_ms=time_ms(lambda: conv2d_dgrad_ref(g, w, hw, st)),
                       library_ms=time_ms(lambda: torch.nn.grad.conv2d_input(xn.shape, wn, gn, stride=st)),
                       bound_ms=b_ms, bound_by=b_by)
            dgrad_rows.append(row)
            line += (f" dgrad err {d_err:.2e} ({d_ratio:.2f} of tol; vs fp64 kernel "
                     f"{fp64_err[0]:.2e} plain {fp64_err[1]:.2e}) {row['ms']:.4f} ms plain "
                     f"{row['plain_ms']:.4f} cudnn {row['library_ms']:.4f} bound {b_ms:.4f} ({b_by});")
        else:
            line += f" dgrad err {d_err:.2e} ({d_ratio:.2f} of tol, not on the path);"
        wgrad_err = max(wgrad_err, w_err)
        check(torch.equal(conv2d_wgrad_tile(x, g, k, stride=st), conv2d_wgrad_tile(x, g, k, stride=st)),
              f"wgrad layer {s['layer']}: two runs on the same inputs differ")
        b_ms, b_by = bound(flops, nbytes)
        row = dict(layer=s["layer"], x=s["x"], w=s["w"], max_abs_err=w_err, err_ratio=w_ratio,
                   ms=time_ms(lambda: conv2d_wgrad_tile(x, g, k, stride=st)),
                   plain_ms=time_ms(lambda: conv2d_wgrad_ref(x, g, k, st)),
                   library_ms=time_ms(lambda: torch.nn.grad.conv2d_weight(xn, wn.shape, gn, stride=st)),
                   bound_ms=b_ms, bound_by=b_by)
        wgrad_rows.append(row)
        print(line + f" wgrad err {w_err:.2e} ({w_ratio:.2f} of normwise tol) {row['ms']:.4f} ms "
              f"plain {row['plain_ms']:.4f} cudnn {row['library_ms']:.4f} bound {b_ms:.4f} ({b_by})")
        del x, w, g, xn, wn, gn

    bwd_extra = [
        # name, x shape, w shape, stride, x dtype, w dtype
        ("stride2", (4, 33, 33, 16), (3, 3, 16, 32), 2, f32, f32),
        ("ragged_r", (2, 14, 13, 3), (3, 3, 3, 5), 2, f32, f32),     # (14-3) % 2 = 1 row
        ("k2_stride2", (2, 16, 15, 8), (2, 2, 8, 24), 2, f32, f32),  # (15-2) % 2 = 1 col
        ("cout1", (2, 17, 17, 24), (3, 3, 24, 1), 1, f32, f32),
        ("odd_cin", (3, 19, 23, 5), (3, 3, 5, 70), 2, f32, f32),
        ("bf16", (4, 30, 30, 128), (3, 3, 128, 256), 1, bf16, bf16),
        ("bf16_x_fp32_w", (4, 30, 30, 128), (3, 3, 128, 256), 1, bf16, f32),
        ("fp32_x_bf16_w", (4, 30, 30, 128), (3, 3, 128, 256), 1, f32, bf16),
    ]
    for name, xs, ws, stride, x_dtype, w_dtype in bwd_extra:
        *_, d_err, d_ratio, w_err, w_ratio = bwd_case(xs, ws, stride, x_dtype, w_dtype)
        print(f"  bwd case {name}: dgrad err {d_err:.2e} ({d_ratio:.3f} of tol), "
              f"wgrad err {w_err:.2e} ({w_ratio:.3f} of tol)")
    print(f"B2/B3 checks passed (dgrad fp32 {TOL_FP32}, wgrad normwise {WGRAD_NORM_TOL} x max "
          f"and bitwise equal on a rerun, bf16 outputs {TOL_BF16})")

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
    by_name = device_ms_by_name(prof, 3)
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
    print(json.dumps({"conv_shapes": rows}))
    print(json.dumps({"dgrad_shapes": dgrad_rows}))
    print(json.dumps({"wgrad_shapes": wgrad_rows}))
    print(json.dumps({"serve": {
        "p50_ms": report.p50_s * 1e3, "p99_ms": report.p99_s * 1e3,
        "img_per_s": report.throughput, "dispatches": report.dispatches,
        "bucket_census": report.bucket_census, "deadline_misses": report.deadline_misses,
        "bucket8_forward_ms": fwd_ms, "bucket8_dispatch_ms": step_s * 1e3,
        "bucket8_kernel_ms": kernel_ms, "max_abs_err": e2e_err, "launches": launches,
        "card": smi,
    }}))
    train_launches = train_phase(dev, groups, smi)
    kernels = [
        kernel_entry("conv2d_tile", "src/repro_torch/kernels/conv2d_tiled/csrc/conv2d_tile.cu",
                     "src/repro/kernels/conv2d_tiled/kernel.py:140", rows,
                     launches + train_launches["conv2d_tile"], serve_err),
        kernel_entry("conv2d_dgrad_tile",
                     "src/repro_torch/kernels/conv2d_tiled/csrc/conv2d_dgrad_tile.cu",
                     "src/repro/kernels/conv2d_tiled/backward.py:59", dgrad_rows,
                     train_launches["conv2d_dgrad_tile"], dgrad_err),
        kernel_entry("conv2d_wgrad_tile",
                     "src/repro_torch/kernels/conv2d_tiled/csrc/conv2d_wgrad_tile.cu",
                     "src/repro/kernels/conv2d_tiled/backward.py:127", wgrad_rows,
                     train_launches["conv2d_wgrad_tile"], wgrad_err),
    ]
    check(all(k["launches"] > 0 for k in kernels), f"launches {[k['launches'] for k in kernels]}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
