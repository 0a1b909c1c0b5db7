"""The port's streaming ``init_lm`` against the former stack-based init.

``init_lm`` allocates each stacked layer leaf once and draws the layers
into its rows; the former init drew every layer's tree, then stacked them
(``torch.stack``), and scaled each draw out of place.  A copy of that init
is kept here, with its initialisers, so the two are held bit for bit at the
same seed for every LM config the port registers, in fp32 and bf16.
"""
import contextlib
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models import attention as attn_mod
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import registry as treg
from repro_torch.models.common import init_norm

LM_IDS = ["qwen2-7b", "mamba2-780m", "stablelm-1.6b", "codeqwen1.5-7b", "command-r-35b",
          "mixtral-8x22b", "jamba-v0.1-52b", "deepseek-v3-671b"]


def _former_dense_init(gen, shape, dtype, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = (1.0 / max(fan_in, 1)) ** 0.5
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * scale).to(dtype)


def _former_embed_init(gen, shape, dtype):
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (w * 0.02).to(dtype)


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack([t[i] for t in trees]) for i in range(len(first))]
    return torch.stack(trees)


@contextlib.contextmanager
def _former_initialisers():
    saved = [(m, getattr(m, "dense_init")) for m in (attn_mod, mlp_mod, mamba_mod)]
    for m, _ in saved:
        m.dense_init = _former_dense_init
    try:
        yield
    finally:
        for m, f in saved:
            m.dense_init = f


def _former_init_lm(gen, cfg):
    """The port's init before streaming: per-layer trees, then ``_stack``;
    an MTP head (DeepSeek-V3) drawn last, as the reference's."""
    dtype = cfg.p_dtype
    with _former_initialisers():
        params = {
            "embed": _former_embed_init(gen, (cfg.vocab, cfg.d_model), dtype),
            "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = _former_embed_init(gen, (cfg.vocab, cfg.d_model), dtype)
        params["segments"] = [
            _stack([[tlm._init_layer(gen, kind, cfg, dtype) for kind in seg.block]
                    for _ in range(seg.repeats)])
            for seg in tlm.plan_segments(cfg)]
        if cfg.mtp_depth > 0:
            params["mtp"] = {
                "proj": _former_embed_init(gen, (2 * cfg.d_model, cfg.d_model), dtype),
                "norm": init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
                "layer": tlm._init_layer(gen, tlm.layer_kind(cfg, cfg.n_layers - 1), cfg,
                                         dtype),
            }
    return params


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _cfg(name, dtype, layers=3):
    """The reduced config at ``layers`` layers (3: repeats that are neither
    1 nor 2) in ``dtype``."""
    cfg = treg.load_config(name, reduced=True)
    return dataclasses.replace(cfg, n_layers=layers, param_dtype=dtype, dtype=dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LM_IDS)
def test_streaming_init_gives_the_former_bits(name, dtype):
    cfg = _cfg(name, dtype)
    got = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    want = _former_init_lm(torch.Generator().manual_seed(0), cfg)
    g, w = _named(got), _named(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    assert ("/lm_head" in dict(g)) == (not cfg.tie_embeddings)
    for (n, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, n     # Mamba2's A_log, D: fp32
        assert a.is_contiguous() and torch.equal(a, b), n
    # the bundle's init is the same function of the seed
    again = treg.bundle_from_cfg(cfg, "cpu").init(0)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(g, _named(again)))


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.calls.append((func, [tuple(o.shape) for o in outs if isinstance(o, torch.Tensor)]))
        return out


@pytest.mark.parametrize("name", ["qwen2-7b", "mamba2-780m", "command-r-35b", "mixtral-8x22b"])
def test_stacked_leaves_are_allocated_once(name):
    """No ``stack`` or ``cat`` on the init path, and the only ops that make
    a stacked leaf's shape are the stacked leaves' allocations, one each
    (the rows are written in place)."""
    cfg = _cfg(name, "float32", layers=5)     # 5: no other leaf has a leading 5
    with _Recorder() as rec:
        params = tlm.init_lm(torch.Generator().manual_seed(0), cfg)
    names = {str(f) for f, _ in rec.calls}
    assert not any("stack" in n or "aten.cat" in n for n in names), sorted(names)
    stacked = [leaf for seg in params["segments"] for _, leaf in _named(seg)]
    assert all(leaf.shape[0] == 5 for leaf in stacked)
    for shape in {tuple(leaf.shape) for leaf in stacked}:
        made = [f for f, shapes in rec.calls if shape in shapes]
        n = sum(tuple(leaf.shape) == shape for leaf in stacked)
        assert len(made) == n and all("empty" in str(f) for f in made), (shape, made)
