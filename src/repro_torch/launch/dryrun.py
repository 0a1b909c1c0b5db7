"""Dry run: every (architecture x shape x mesh) cell's step built on
abstract tensors and traced on fake ones, its FLOPs, bytes and memory per
device counted, one JSON artifact per cell for the roofline table - the
port's ``repro/launch/dryrun.py``, with the same CLI and JSON keys.

"Lowering" (``lower_train``, ``lower_prefill``, ``lower_decode``) builds the
step and its abstract arguments - the train state (``train/trainer.py:
abstract_state``), the params, the batch specs, the caches, all ``meta``
tensors - and each argument's spec on the virtual mesh
(``parallel/sharding.py``).  "Compiling" (``_compile_stats``) runs the step
once under ``FakeTensorMode`` on CPU fake tensors, under the mesh it was
lowered for: nothing is allocated or launched, and each kernel's dispatch
takes its plain version.  ``FlopCounterMode`` counts the FLOPs and a
dispatch-level counter the bytes.

Methodology, against the reference's:

- ``flops``: every executed op is counted (there is no scan whose body is
  counted once), so the full-depth trace counts directly.  Train and
  prefill cells trace under ``attention_impl("stub")``, which also stands in
  for B4, and add the flash kernel's analytic terms back
  (``analysis/roofline.py:flash_attention_terms``), as the reference's
  counting lowerings do.  With rates on, the reference's shallow depths
  (1 and 2 periods, ``with_depth``) are traced too and scaled by its
  ``s1 + (R - 1)(s2 - s1)``: a check against the direct count, not the
  method.  Decode cells are counted directly, attention included.
- ``bytes``: torch has no "bytes accessed".  Every non-view aten op adds its
  operands' and results' bytes: an unfused count, above XLA's fused one.
- per device: the virtual mesh computes the global step on one device, so
  a count per device is the global count over the mesh's devices (a
  perfect split).  ``mem.argument_bytes`` per device is each argument
  leaf's bytes over the sizes of the mesh axes its spec names;
  ``output_bytes`` the results no argument holds (an in-place update
  writes its argument), whole.  ``hbm_ok`` holds the argument bytes to
  ``H100.hbm_bytes`` and ``roofline_fraction`` takes ``H100.peak_flops``.
- no counterpart, ``null``: ``temp_bytes`` and ``alias_bytes`` (no
  compiler plans the buffers of an eager step) and the collective keys
  ``coll_ring``, ``coll_naive``, ``coll_count`` (the virtual mesh runs no
  collective: ``parallel/api.py``'s ``constrain`` and
  ``gather_for_compute`` are identities).  The roofline's collective term
  takes 0 bytes, and ``summarize`` prints it "n/a".
- train and prefill trace with ``unroll``, which in the port merges the
  cross-entropy chunks into one (the layers are always a Python loop): the
  same FLOPs in a trace of far fewer ops.

A step whose trace needs a data-dependent value (``.item()``, a
``nonzero``) raises, and ``main`` records the cell's ``"error"``, as the
reference's does for a cell that fails to compile.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh single --no-rates --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.roofline import (
    H100,
    count_params_cfg,
    embed_param_count,
    flash_attention_terms,
    fmt_bytes,
    fmt_seconds,
    model_flops,
    terms_from_counts,
)
from repro_torch.ckpt.manager import map_with_path
from repro_torch.configs.base import SHAPES, ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.mesh import VirtualMesh, make_production_mesh
from repro_torch.models.attention import attention_impl
from repro_torch.models.registry import (
    ARCH_IDS,
    bundle_from_cfg,
    cell_supported,
    load_config,
    period_counts,
    with_depth,
)
from repro_torch.parallel.api import layout_rules, sharding_ctx
from repro_torch.parallel.sharding import (
    batch_shardings,
    cache_shardings,
    param_shardings,
    state_shardings,
)

# the step is traced on the CPU: its fake tensors dispatch the kernels'
# plain versions, whatever device the mesh names
TRACE_DEVICE = "cpu"


@dataclasses.dataclass
class Lowered:
    """A step ready to trace: ``fn(*args)`` on fake tensors made from the
    abstract (``meta``) ``args``, under ``mesh`` and ``rules``; ``specs``
    holds each argument leaf's spec on the mesh (``None``: replicated)."""

    fn: Callable
    args: tuple
    specs: tuple
    mesh: VirtualMesh
    rules: dict


# ---------------------------------------------------------------------------
# Per-kind lowering
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _abstract_params(cfg):
    return bundle_from_cfg(cfg, TRACE_DEVICE).abstract_params()


def _pick_optimizer(cfg) -> str:
    """adafactor above ~100B params (factored moments; HBM fit), else adamw."""
    total, _ = count_params_cfg(_abstract_params(cfg), cfg)
    return "adafactor" if total > 1e11 else "adamw"


def _spec_tensors(specs: dict) -> dict:
    """A batch's ``TensorSpec``s as ``meta`` tensors."""
    return {k: torch.empty(s.shape, dtype=s.dtype if isinstance(s.dtype, torch.dtype)
                           else getattr(torch, np.dtype(s.dtype).name), device="meta")
            for k, s in specs.items()}


def lower_train(cfg, shape: ShapeConfig, mesh: VirtualMesh, *, unroll: bool, pcfg=None,
                layout: str = "tp-sp", tcfg: Optional[TrainConfig] = None) -> Lowered:
    """The LM train step (``make_train_step``, remat full unless ``pcfg``
    says otherwise) on the abstract state and batch.  ``tcfg`` defaults to
    the reference's: ``TrainConfig`` with ``_pick_optimizer``'s optimizer."""
    from repro_torch.train.trainer import TrainState, abstract_of, make_train_step

    bundle = bundle_from_cfg(cfg, TRACE_DEVICE)
    pcfg = pcfg or ParallelConfig(unroll=unroll, remat="full")
    if unroll and not pcfg.unroll:
        pcfg = dataclasses.replace(pcfg, unroll=True)
    tcfg = tcfg or TrainConfig(optimizer=_pick_optimizer(cfg))
    init_state, train_step = make_train_step(bundle, pcfg, tcfg)
    state_abs = abstract_of(init_state)[0]
    batch_abs = _spec_tensors(bundle.input_specs(shape))
    rules = layout_rules(layout)
    with sharding_ctx(mesh, rules=rules):
        p_sh = param_shardings(state_abs.params)
        o_sh = state_shardings(state_abs.opt, state_abs.params)
        ef_sh = None if state_abs.ef is None else param_shardings(state_abs.ef)
        state_sh = TrainState(p_sh, o_sh, None, ef_sh)
        b_sh = batch_shardings(batch_abs)
    return Lowered(train_step, (state_abs, batch_abs), (state_sh, b_sh), mesh, rules)


def lower_prefill(cfg, shape: ShapeConfig, mesh: VirtualMesh, *, unroll: bool,
                  layout: str = "tp-sp") -> Lowered:
    """The prefill forward: the last position's fp32 logits."""
    from repro_torch.models import lm as lm_mod
    from repro_torch.models import whisper as whisper_mod

    bundle = bundle_from_cfg(cfg, TRACE_DEVICE)
    batch_abs = _spec_tensors(bundle.input_specs(shape))

    if cfg.encoder_decoder:
        def prefill_step(params, batch):
            enc = whisper_mod.encode(params, batch["frames"], cfg, remat="none", unroll=unroll)
            hidden = whisper_mod.decode_train(params, batch["tokens"], enc, cfg, remat="none",
                                              unroll=unroll)
            head = params["embed"].to(cfg.act_dtype)
            return (hidden[:, -1:] @ head.T).float()
    else:
        def prefill_step(params, batch):
            hidden = lm_mod.apply_lm(params, batch["tokens"], cfg,
                                     positions=batch.get("positions"),
                                     extra_embeds=batch.get("patch_embeds"), remat="none",
                                     unroll=unroll)
            head = lm_mod.lm_head_weight(params, cfg).to(cfg.act_dtype)
            return (hidden[:, -1:] @ head.T).float()

    params_abs = _abstract_params(cfg)
    rules = layout_rules(layout)
    with sharding_ctx(mesh, rules=rules):
        p_sh = param_shardings(params_abs)
        b_sh = batch_shardings(batch_abs)

    def step(params, batch):
        with torch.no_grad():
            return prefill_step(params, batch)

    return Lowered(step, (params_abs, batch_abs), (p_sh, b_sh), mesh, rules)


def lower_decode(cfg, shape: ShapeConfig, mesh: VirtualMesh, *, seq_sharded: bool,
                 layout: str = "tp-sp") -> Lowered:
    """One serving tick: a token a slot against caches of ``seq_len`` rows,
    written in place."""
    bundle = bundle_from_cfg(cfg, TRACE_DEVICE)
    b, s = shape.global_batch, shape.seq_len
    params_abs = _abstract_params(cfg)
    caches_abs = bundle.cache_specs(b, s)
    token_abs = torch.empty((b, 1), dtype=torch.int32, device="meta")

    def serve_step(params, token, caches):
        with torch.no_grad():
            if cfg.encoder_decoder:
                return bundle.decode_fn(params, token, caches)
            return bundle.decode_fn(params, token, caches, seq_sharded=seq_sharded)

    rules = layout_rules(layout)
    with sharding_ctx(mesh, rules=rules):
        p_sh = param_shardings(params_abs)
        c_sh = cache_shardings(caches_abs, seq_sharded=seq_sharded)
        t_sh = batch_shardings({"token": token_abs})["token"]
    return Lowered(serve_step, (params_abs, token_abs, caches_abs), (p_sh, t_sh, c_sh), mesh,
                   rules)


# ---------------------------------------------------------------------------
# Cell analysis
# ---------------------------------------------------------------------------


def _tensor_bytes(xs) -> int:
    """The bytes of the tensors among ``xs`` and in its lists (a TensorList
    operand or result)."""
    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            n += _tensor_bytes(x)
    return n


class ByteCounter(TorchDispatchMode):
    """Adds the bytes of the tensor operands and results of every aten op
    that makes a tensor and is no view: an unfused count of the step's
    memory traffic (a metadata query such as ``prim.device`` moves
    nothing)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    # a reshape that aliases its input without saying so in its schema
    ZERO_COPY = frozenset({torch.ops.aten._unsafe_view.default})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        if not (func.is_view or func in self.ZERO_COPY) and \
                any(isinstance(x, torch.Tensor) for x in outs):
            self.bytes += _tensor_bytes(args) + _tensor_bytes(kwargs.values()) + \
                _tensor_bytes(outs)
        return out


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _per_device(nbytes: int, spec, mesh: VirtualMesh) -> int:
    """A leaf's bytes on one device: over the sizes of the axes its spec
    names (a spec entry is None, an axis, or a tuple of axes)."""
    div = 1
    for entry in spec or ():
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            div *= mesh.shape[a]
    return nbytes // div


def leaf_bytes(args: tuple, specs: Optional[tuple] = None,
               mesh: Optional[VirtualMesh] = None) -> dict:
    """Each tensor leaf's bytes by path (``arg<i>/...``, the paths of
    ``ckpt/manager.py:map_with_path``): on one device of ``mesh`` where
    ``specs`` are given - a spec tree follows its argument's structure down
    to a spec tuple (or ``None``, replicated) at each tensor leaf -, whole
    otherwise."""
    from repro_torch.ckpt.manager import _is_namedtuple

    out: dict[str, int] = {}

    def walk(path, x, spec):
        if isinstance(x, torch.Tensor):
            out[path] = _nbytes(x) if mesh is None else _per_device(_nbytes(x), spec, mesh)
        elif _is_namedtuple(x):
            for f in x._fields:
                walk(f"{path}/{f}", getattr(x, f), getattr(spec, f, None))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(f"{path}/{k}", x[k], None if spec is None else spec[k])
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{path}/{i}", v, None if spec is None else spec[i])

    for i, arg in enumerate(args):
        walk(f"arg{i}", arg, None if specs is None else specs[i])
    return out


def argument_bytes(lowered: Lowered) -> dict:
    """Each argument leaf's bytes on one device of the lowering's mesh."""
    return leaf_bytes(lowered.args, lowered.specs, lowered.mesh)


def _fake(tree):
    """``meta`` leaves -> tensors on ``TRACE_DEVICE`` of the same shape and
    dtype: fake ones, allocating nothing, under a ``FakeTensorMode``."""
    def leaf(_, x):
        if isinstance(x, torch.Tensor):
            return torch.empty(x.shape, dtype=x.dtype, device=TRACE_DEVICE)
        return x

    return map_with_path(leaf, tree)


def _storage_key(x) -> int:
    return x.untyped_storage()._cdata


def _compile_stats(lowered: Lowered) -> dict:
    """Trace ``lowered`` once on fake tensors and count it (module
    docstring); the keys of the reference's, ``null`` where the port has no
    counterpart."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.monotonic()
    mode = FakeTensorMode()
    with mode:
        args = tuple(_fake(a) for a in lowered.args)
    held = {_storage_key(x) for x in tree_flatten(args)[0] if isinstance(x, torch.Tensor)}
    counter, flops = ByteCounter(), FlopCounterMode(display=False)
    with mode, sharding_ctx(lowered.mesh, rules=lowered.rules), flops, counter:
        out = lowered.fn(*args)
    dt = time.monotonic() - t0
    arg_bytes = sum(argument_bytes(lowered).values())
    out_bytes = sum(_nbytes(x) for x in tree_flatten(out)[0]
                    if isinstance(x, torch.Tensor) and _storage_key(x) not in held)
    n = int(np.prod(list(lowered.mesh.shape.values())))
    return {
        "compile_s": round(dt, 2),
        "flops": float(flops.get_total_flops()) / n,
        "bytes": float(counter.bytes) / n,
        "coll_ring": None,
        "coll_naive": None,
        "coll_count": None,
        "mem": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": None,
            "alias_bytes": None,
            "total_bytes": arg_bytes + out_bytes,
        },
    }


def run_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    *,
    rates: bool = True,
    seq_shard_long: bool = True,
    pcfg: ParallelConfig | None = None,
    layout: str = "tp-sp",
    cfg_transform=None,
    device: str | torch.device = "cuda",
) -> dict:
    cfg = load_config(arch)
    if cfg_transform is not None:
        cfg = cfg_transform(cfg)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "skipped": why}
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device=device)
    n_dev = int(np.prod(list(mesh.shape.values())))
    out: dict = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "kind": shape.kind,
        "devices": n_dev,
        "layout": layout,
    }

    total, active = count_params_cfg(_abstract_params(cfg), cfg)
    out["params_total"] = total
    out["params_active"] = active

    def lower(c):
        if shape.kind == "train":
            return lower_train(c, shape, mesh, unroll=True, pcfg=pcfg, layout=layout)
        if shape.kind == "prefill":
            return lower_prefill(c, shape, mesh, unroll=True, layout=layout)
        # 32k+ caches shard over *sequence* (flash-decode): KV-head counts
        # need not divide TP, and the cache is the decode working set
        return lower_decode(c, shape, mesh,
                            seq_sharded=(shape.seq_len >= 32_768 and seq_shard_long),
                            layout=layout)

    if shape.kind == "decode":
        # one token against the caches: counted directly, attention included
        full = _compile_stats(lower(cfg))
        out["full"] = full
        flops, bytes_hbm = full["flops"], full["bytes"]
        out["rates"] = {"method": "direct"}
    else:
        # the full-depth trace with the attention stubbed; the flash
        # kernel's analytic terms added back
        with attention_impl("stub"):
            full = _compile_stats(lower(cfg))
        out["full"] = full
        fa_fl, fa_by = flash_attention_terms(cfg, shape, remat=(shape.kind == "train"))
        flops = full["flops"] + fa_fl / n_dev
        bytes_hbm = full["bytes"] + fa_by / n_dev
        prefix, reps = period_counts(cfg)
        out["rates"] = {
            "method": "direct+flash-analytic",
            "prefix_layers": prefix,
            "periods": reps,
            "flash_flops_global": fa_fl,
            "flash_bytes_global": fa_by,
        }
        if rates:
            # the reference's depth scaling, as a check of the direct count
            with attention_impl("stub"):
                s1 = _compile_stats(lower(with_depth(cfg, 1)))
                s2 = _compile_stats(lower(with_depth(cfg, 2)))

            def scale(k):
                return s1[k] + (reps - 1) * (s2[k] - s1[k])

            out["rates"].update(
                d1={k: s1[k] for k in ("flops", "bytes", "coll_ring", "compile_s")},
                d2={k: s2[k] for k in ("flops", "bytes", "coll_ring", "compile_s")},
                scaled_flops=scale("flops"),
                scaled_bytes=scale("bytes"),
            )

    out["hbm_ok"] = bool(full["mem"]["argument_bytes"] <= H100.hbm_bytes)
    if mesh_kind != "single" and shape.kind != "decode" and rates is False:
        # as the reference's: a multi-pod cell proves the specs and the fit only
        out["roofline"] = "n/a (multi-pod compile-proof cell)"
        return out
    terms = terms_from_counts(flops, bytes_hbm, 0.0, H100)
    mf = model_flops(cfg, shape, active, embed_params=embed_param_count(cfg))
    out.update(
        flops_per_device=flops,
        bytes_per_device=bytes_hbm,
        coll_ring_per_device=None,
        coll_naive_per_device=None,
        compute_s=terms.compute_s,
        memory_s=terms.memory_s,
        collective_s=terms.collective_s,
        dominant=terms.dominant,
        bound_s=terms.bound_s,
        model_flops_global=mf,
        model_flops_per_device=mf / n_dev,
        useful_ratio=(mf / n_dev) / flops if flops else 0.0,
        roofline_fraction=(mf / n_dev / H100.peak_flops) / terms.bound_s
        if terms.bound_s
        else 0.0,
    )
    return out


def summarize(res: dict) -> str:
    head = f"[{res['arch']} x {res['shape']} @ {res['mesh']}]"
    if "skipped" in res:
        return f"{head} SKIP: {res['skipped']}"
    mem = (f"args/dev={fmt_bytes(res['full']['mem']['argument_bytes'])} "
           f"(fits={res['hbm_ok']})")
    if "compute_s" not in res:
        return f"{head} COMPILE OK {mem}"
    coll = ("n/a" if res["coll_ring_per_device"] is None
            else fmt_seconds(res["collective_s"]))
    return (
        f"{head} "
        f"compute={fmt_seconds(res['compute_s'])} "
        f"memory={fmt_seconds(res['memory_s'])} "
        f"collective={coll} "
        f"dominant={res['dominant']} "
        f"roofline={res['roofline_fraction']:.1%} "
        f"{mem}"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every supported cell")
    ap.add_argument("--outdir", default="artifacts/dryrun")
    ap.add_argument("--no-rates", action="store_true",
                    help="skip the shallow depth-scaling check")
    ap.add_argument("--layout", default="tp-sp",
                    help="parallelism layout (see parallel.api.LAYOUTS)")
    ap.add_argument("--remat", default="full", choices=["none", "full", "dots"])
    ap.add_argument("--ssm-chunk", type=int, default=0, help="override SSD chunk size")
    ap.add_argument("--suffix", default="", help="artifact filename suffix (layout experiments)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device: 'cuda' (default) or 'cpu'; the step is traced "
                         "on CPU fake tensors either way")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(arch, shape, mk) for arch in ARCH_IDS for shape in SHAPES for mk in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, mk) for mk in meshes]

    if args.list:
        for c in cells:
            print(*c)
        return 0

    def transform(c):
        if c.ssm is None:
            return c
        return dataclasses.replace(c, ssm=dataclasses.replace(c.ssm, chunk=args.ssm_chunk))

    os.makedirs(args.outdir, exist_ok=True)
    failures = 0
    for arch, shape, mk in cells:
        name = f"{arch}__{shape}__{mk}{args.suffix}.json".replace("/", "_")
        path = os.path.join(args.outdir, name)
        try:
            res = run_cell(
                arch, shape, mk,
                rates=(mk == "single" and not args.no_rates),
                layout=args.layout,
                pcfg=ParallelConfig(remat=args.remat),
                cfg_transform=transform if args.ssm_chunk else None,
                device=args.device,
            )
            print(summarize(res), flush=True)
        except Exception as e:  # noqa: BLE001 - recorded in the cell's artifact
            failures += 1
            res = {
                "arch": arch, "shape": shape, "mesh": mk,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            print(f"[{arch} x {shape} @ {mk}] FAIL: {res['error']}", flush=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
