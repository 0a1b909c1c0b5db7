"""How far each fp32 trainer lands from fp64 on one plan, and why one leaf is loose.

``chip_smoke.py:train_phase`` holds the port's 3-step update on each leaf to
2x the fp32 torch-backend trainer's distance from the fp64 trainer (ROADMAP
C.20).  This script measures that distance on the plan where the port sits
nearest its bar, phase 14's padded pi3x3+jetson plan (2x2, groups="auto",
batch 8 in 2 microbatches, SGD, 3 steps, seed 0), and prints one JSON line
per question:

- ``trainers``: each fp32 trainer's normwise update error against the fp64
  trainer, for every bn_bias leaf and the worst leaf: the torch backend
  (cuDNN) under its default algorithms (three runs) and its deterministic
  ones (two), the cuda backend (B1-B3) twice, and the cuda backend with one
  of B1-B3, or all three, swapped for its plain version (``ref.py``, on
  cuDNN's deterministic algorithms);
- ``conditioning``: for each BN layer, in fp64 on step 1's batch, the
  largest per-channel sum of |dL/dz| over the largest |sum of dL/dz| (z the
  BN output, whose per-channel sum is the bn_bias gradient): the factor by
  which rounding in that sum grows relative to the gradient;
- ``forward``: for each conv layer, its fp32 output on step 1's first
  microbatch (untiled; the input is the fp64 forward's, rounded to fp32)
  from B1 and from cuDNN (deterministic and default algorithms) against
  the fp64 conv of the same fp32 operands: the max error over the max
  output, and the relative 2-norm error.

Run on a card from the repo root: ``python3 chip_bar_probe.py`` (builds
B1-B3 first; about a minute on an H100).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import chip_smoke as cs


def main() -> None:
    import torch

    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.core.backend import ACTIVATIONS
    from repro_torch.core.spatial import apply_layer_reference
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d_tiled import ops, ref
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models.yolo import l2_loss_local, make_yolo_tiled_arch
    from repro_torch.optim.optimizers import make_optimizer, tree_leaves, tree_map
    from repro_torch.train.trainer import TrainState, make_train_step

    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    _build.build(("conv2d_tile", "conv2d_dgrad_tile", "conv2d_wgrad_tile"))
    torch.backends.cudnn.allow_tf32 = False          # as chip_smoke.py sets them
    torch.backends.cuda.matmul.allow_tf32 = False

    kw = dict(cs._CLUSTER_KW, groups="auto", ragged_exec="padded")

    def make_arch(backend):
        return make_yolo_tiled_arch(input_hw=cs.INPUT_HW, depth=16, n=2, m=2, backend=backend,
                                    device=dev, **kw)

    arch = make_arch("cuda")
    plan = arch.plan
    pcfg = ParallelConfig(grad_accum=cs.TRAIN_ACCUM)
    tcfg = TrainConfig(lr=cs.TRAIN_LR, optimizer="sgd", warmup=0, steps=cs.TRAIN_STEPS,
                       seed=cs.SEED)
    make_batch = make_batch_fn(cs.TRAIN_BATCH, cs.INPUT_HW[0], arch.target_shape(cs.TRAIN_BATCH),
                               cs.SEED, dev)
    params0 = make_train_step(arch, pcfg, tcfg)[0](cs.SEED).params
    names = [f"{i}.{k}" for i, p in enumerate(params0) for k in p]
    p0 = tree_leaves(params0)

    def trainer_run(backend, dtype):
        init, step = make_train_step(make_arch(backend), pcfg, tcfg)
        p = tree_map(lambda t: t.to(dtype), init(cs.SEED).params)
        st = TrainState(p, make_optimizer(tcfg.optimizer).init(p), 0)
        for s in range(cs.TRAIN_STEPS):
            st, _ = step(st, {k: v.to(dtype) for k, v in make_batch(s).items()})
        return tree_leaves(st.params)

    with cs.deterministic_cudnn():
        upd64 = [a.double() - b.double() for a, b in zip(trainer_run("torch", torch.float64), p0)]

    def errs(fin):
        return {n: float(((a.double() - b.double()) - u).abs().max() / u.abs().max())
                for n, a, b, u in zip(names, fin, p0, upd64)}

    plain = {
        "conv2d_tile": lambda x, w, b, stride=1, act="linear", block_oh=None:
            ref.conv2d_ref(x, w, b, stride=stride, act=act),
        "conv2d_dgrad_tile": lambda g, w, in_hw, stride=1, block_oh=None:
            ref.conv2d_dgrad_ref(g, w, in_hw, stride),
        "conv2d_wgrad_tile": lambda x, g, kernel, stride=1, out_dtype=None:
            ref.conv2d_wgrad_ref(x, g, kernel, stride, out_dtype),
    }
    ported = {k: getattr(ops, k) for k in plain}

    def cuda_with_plain(swap):
        for k in plain:
            setattr(ops, k, plain[k] if k in swap else ported[k])
        try:
            with cs.deterministic_cudnn():
                return errs(trainer_run("cuda", torch.float32))
        finally:
            for k, f in ported.items():
                setattr(ops, k, f)

    runs = []
    for i in range(3):
        runs.append(("torch default cuDNN", i, errs(trainer_run("torch", torch.float32))))
    for i in range(2):
        with cs.deterministic_cudnn():
            runs.append(("torch deterministic cuDNN", i, errs(trainer_run("torch", torch.float32))))
    for i in range(2):
        runs.append(("cuda B1-B3", i, cuda_with_plain(())))
    for swap in (("conv2d_tile",), ("conv2d_dgrad_tile",), ("conv2d_wgrad_tile",), tuple(plain)):
        runs.append((f"cuda, plain {'+'.join(swap)}", 0, cuda_with_plain(swap)))
    bn = [n for n in names if n.endswith("bn_bias")]
    rows = []
    for what, i, e in runs:
        worst = max(e, key=e.get)
        rows.append({"trainer": what, "run": i, "bn_bias": {n: e[n] for n in bn},
                     "worst_leaf": [worst, e[worst]]})
        print(f"{what} #{i}: 13.bn_bias {e['13.bn_bias']:.6f}; worst {worst} {e[worst]:.6f}",
              flush=True)
    print(json.dumps({"trainers": rows, "plan": "phase 14 cluster padded", "card": smi}))

    # the conditioning of each bn_bias gradient at step 1, in fp64, untiled
    x, t = make_batch(0)["x"].double(), make_batch(0)["t"].double()
    live = [{k: v.detach().double() for k, v in p.items()} for p in params0]
    probes: dict[int, list] = {}
    loss = 0.0
    for xm, tm in zip(x.chunk(cs.TRAIN_ACCUM), t.chunk(cs.TRAIN_ACCUM)):
        h = xm
        for i, (p, layer) in enumerate(zip(live, plan.layers)):
            if layer.batch_norm and not layer.pool:
                z = apply_layer_reference(h, p, dataclasses.replace(layer, act="linear"))
                e = torch.zeros_like(z, requires_grad=True)
                probes.setdefault(i, []).append(e)
                h = ACTIVATIONS[layer.act](z + e)
            else:
                h = apply_layer_reference(h, p, layer)
        s, c = l2_loss_local(h, tm)
        loss = loss + s / c
    loss = loss / cs.TRAIN_ACCUM
    order = list(probes)
    grads = torch.autograd.grad(loss, [e for i in order for e in probes[i]])
    cond = {}
    for j, i in enumerate(order):
        dz = torch.cat(grads[j * cs.TRAIN_ACCUM:(j + 1) * cs.TRAIN_ACCUM])
        total = dz.sum(dim=(0, 1, 2))
        cond[f"{i}.bn_bias"] = {"cond": float(dz.abs().sum(dim=(0, 1, 2)).max()
                                              / total.abs().max()),
                                "terms": int(dz[..., 0].numel()),
                                "grad_max": float(total.abs().max())}
    for n, c in cond.items():
        print(f"{n}: conditioning {c['cond']:.1f} over {c['terms']} terms a channel", flush=True)
    print(json.dumps({"conditioning": cond, "card": smi}))

    # each conv's fp32 rounding alone: B1 and cuDNN on the same fp32 operands
    def rel(y, y64):
        d = y.double() - y64
        return [float(d.abs().max() / y64.abs().max()), float(d.norm() / y64.norm())]

    fwd = {}
    h = x.chunk(cs.TRAIN_ACCUM)[0]
    with torch.no_grad():
        for i, (p, layer) in enumerate(zip(live, plan.layers)):
            if not layer.pool:
                pad = layer.padding
                xp = torch.nn.functional.pad(h.float(), (0, 0, pad, pad, pad, pad)).contiguous()
                w = p["w"].float()
                y64 = ref.conv2d_ref(xp.double(), w.double(), stride=layer.stride)
                got = {"B1": ported["conv2d_tile"](xp, w, None, stride=layer.stride)}
                with cs.deterministic_cudnn():
                    got["cudnn_deterministic"] = ref.conv2d_ref(xp, w, stride=layer.stride)
                got["cudnn_default"] = ref.conv2d_ref(xp, w, stride=layer.stride)
                fwd[i] = {"shape": [list(xp.shape), list(w.shape)],
                          **{k: rel(v, y64) for k, v in got.items()}}
                print(f"conv {i} {fwd[i]['shape']}: " + ", ".join(
                    f"{k} {v[0]:.2e} / {v[1]:.2e}" for k, v in fwd[i].items() if k != "shape"),
                    flush=True)
            h = apply_layer_reference(h, p, layer)
    print(json.dumps({"forward": fwd, "seconds": time.perf_counter() - t0, "card": smi}))


if __name__ == "__main__":
    main()
