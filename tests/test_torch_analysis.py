"""The port's analysis tooling against the reference's: the roofline model
(``analysis/roofline.py``: the hardware targets, ``terms_from_counts``,
``model_flops`` and ``flash_attention_terms`` equal for every supported cell
of every architecture, the formatters), ``models.attention.attention_impl``
(the cases of ``tests/test_attention.py:48-66`` on the same numpy q/k/v, and
the stub standing in for the flash route alone), and ``compat``.  Whole
file ~15 s on one worker."""
import dataclasses
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat as ref_compat
from repro.analysis import roofline as ref_roofline
from repro.configs import base as ref_base
from repro.core import fusion as ref_fusion
from repro.models import attention as ref_attn
from repro.models import registry as ref_registry
from repro_torch import compat
from repro_torch.analysis import roofline
from repro_torch.analysis.roofline import H100, H100_FP32_PEAK_FLOPS, V5E
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core import fusion
from repro_torch.models import attention as attn_mod
from repro_torch.models import registry
from repro_torch.models.yolo import yolov2_16_layers
from repro_torch.optim.optimizers import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(ref_registry.ARCH_IDS)
TOL = dict(atol=2e-5, rtol=1e-4)        # tests/test_kernels.py:22-23, fp32


def test_hardware_targets():
    assert dataclasses.asdict(V5E) == dataclasses.asdict(ref_roofline.V5E)
    assert (H100.name, H100.peak_flops, H100.hbm_bw, H100.hbm_bytes) == \
        ("h100-sxm-80gb", 989e12, 3.35e12, 80e9)
    assert (H100.ici_bw, H100.dcn_bw) == (900e9, 900e9)
    assert H100_FP32_PEAK_FLOPS == 67e12


def test_chip_smoke_takes_its_peaks_from_the_h100_target():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(REPO)
    assert cs.FP32_PEAK_FLOPS == H100_FP32_PEAK_FLOPS == 67e12
    assert cs.HBM_BYTES_PER_S == H100.hbm_bw == 3.35e12
    assert cs.BF16_PEAK_FLOPS == H100.peak_flops == 989e12
    # a kernel's bound is unchanged by that: 1 GFLOP fp32 beside 1 GB
    assert cs.bound(10**9, 10**9)[0] == max(1e9 / 67e12, 1e9 / 3.35e12) * 1e3


@pytest.mark.parametrize("counts", [(1e15, 1e12, 0.0), (2e12, 8e11, 5e9), (0.0, 0.0, 1e9)])
def test_terms_from_counts_match_the_reference(counts):
    for hw, ref_hw in ((V5E, ref_roofline.V5E), (H100, ref_roofline.HardwareTarget(
            **dataclasses.asdict(H100)))):
        got = roofline.terms_from_counts(*counts, hw)
        want = ref_roofline.terms_from_counts(*counts, ref_hw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert (got.dominant, got.bound_s) == (want.dominant, want.bound_s)


def test_formatters_match_the_reference():
    for v in (0.0, 3e-7, 4.2e-3, 17.5, 1234.5, 3.5e9, 7.1e13, 2.2e18):
        assert roofline.fmt_seconds(v) == ref_roofline.fmt_seconds(v)
        assert roofline.fmt_bytes(v) == ref_roofline.fmt_bytes(v)
        assert roofline.fmt_flops(v) == ref_roofline.fmt_flops(v)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_model_flops_and_flash_terms_match_the_reference(arch, reduced):
    """Every supported cell, exactly: the same arithmetic on each
    package's own config and shape."""
    cfg, ref_cfg = registry.load_config(arch, reduced), ref_registry.load_config(arch, reduced)
    assert roofline.embed_param_count(cfg) == ref_roofline.embed_param_count(ref_cfg)
    shapes = [(SHAPES[k], ref_base.SHAPES[k]) for k in SHAPES] + [
        (ShapeConfig("card", 2048, 4, "train"), ref_base.ShapeConfig("card", 2048, 4, "train"))]
    n = 0
    for shape, ref_shape in shapes:
        if not registry.cell_supported(cfg, shape)[0]:
            continue
        n += 1
        for active, embed in ((7_615_616_512, 0), (35_723_196_416, 926_679_040), (1, 5)):
            assert roofline.model_flops(cfg, shape, active, embed_params=embed) == \
                ref_roofline.model_flops(ref_cfg, ref_shape, active, embed_params=embed)
        for kw in ({}, {"remat": False}, {"q_block": 512}):
            assert roofline.flash_attention_terms(cfg, shape, **kw) == \
                ref_roofline.flash_attention_terms(ref_cfg, ref_shape, **kw)
    assert n >= 3


# ---------------------------------------------------------------------------
# attention_impl
# ---------------------------------------------------------------------------


def _qkv(seed, b, t, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, t, hq, dh), (b, t, hkv, dh), (b, t, hkv, dh))]


@pytest.mark.parametrize("mode,chunks", [("stub", {}), ("blocked", dict(q_chunk=32, kv_chunk=32)),
                                         ("naive", {}), ("auto", {})])
@pytest.mark.parametrize("shape,causal,window", [((1, 64, 4, 4, 32), True, None),
                                                 ((2, 96, 8, 2, 32), True, 40),
                                                 ((1, 64, 4, 1, 16), False, None)])
def test_attention_impl_matches_the_reference(mode, chunks, shape, causal, window):
    q, k, v = _qkv(sum(shape), *shape)
    t = shape[1]
    with attn_mod.attention_impl(mode, **chunks):
        got = attn_mod._sdpa(*map(torch.from_numpy, (q, k, v)), torch.arange(t),
                             torch.arange(t), causal=causal, window=window)
    with ref_attn.attention_impl(mode, **chunks):
        want = ref_attn._sdpa(*map(jnp.asarray, (q, k, v)), jnp.arange(t, dtype=jnp.int32),
                              jnp.arange(t, dtype=jnp.int32), causal=causal, window=window)
    assert got.shape == tuple(want.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert attn_mod._ATTN.mode == "auto"      # restored on exit


def test_blocked_and_naive_agree_as_in_the_reference():
    """``tests/test_attention.py:test_attention_impl_context`` on the port."""
    q, k, v = map(torch.from_numpy, _qkv(2, 1, 64, 4, 4, 32))
    pos = torch.arange(64)
    with attn_mod.attention_impl("stub"):
        out = attn_mod._sdpa(q, k, v, pos, pos, causal=True, window=None)
    assert out.shape == q.shape
    with attn_mod.attention_impl("blocked", q_chunk=32, kv_chunk=32):
        blk = attn_mod._sdpa(q, k, v, pos, pos, causal=True, window=None)
    ref = attn_mod._sdpa_naive(q, k, v, pos, pos, causal=True, window=None)
    torch.testing.assert_close(blk, ref, **TOL)


def test_stub_keeps_the_grad_path():
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(3, 1, 32, 2, 2, 16))
    pos = torch.arange(32)
    gq, gk, gv = torch.autograd.grad(attn_mod._sdpa_stub(q, k, v, pos, pos).sum(), (q, k, v))
    assert gv.shape == v.shape and bool((gv != 0).any())
    assert gq.shape == q.shape and gk.shape == k.shape      # on the path, with zero weight
    # the reference's stub gives the same value gradient
    ref_gv = jax.grad(lambda v_: jnp.sum(ref_attn._sdpa_stub(
        jnp.asarray(q.detach().numpy()), jnp.asarray(k.detach().numpy()), v_, None, None)))(
        jnp.asarray(v.detach().numpy()))
    np.testing.assert_allclose(gv.numpy(), np.asarray(ref_gv), **TOL)


@pytest.mark.parametrize("mode,flash_calls", [("auto", 1), ("naive", 1), ("blocked", 1),
                                              ("stub", 0)])
def test_only_the_stub_replaces_the_flash_route(monkeypatch, mode, flash_calls):
    """The training path's attention runs the flash op (B4 on a card) in
    every mode but the counting stub: "naive" and "blocked" choose how the
    plain ``_sdpa`` computes and never take B4 off the path."""
    cfg = registry.load_config("qwen2-7b", reduced=True)
    params = attn_mod.init_attention(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(16)[None].expand(2, 16)
    calls = []
    real = attn_mod.flash_attention
    monkeypatch.setattr(attn_mod, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with attn_mod.attention_impl(mode):
        y = attn_mod.attention(params, x, pos, cfg, arange_positions=True)
    assert len(calls) == flash_calls
    assert y.shape == x.shape
    if mode != "stub":
        with attn_mod.attention_impl("stub"):
            assert not torch.equal(attn_mod.attention(params, x, pos, cfg, arange_positions=True),
                                   y)


def test_attention_impl_rejects_an_unknown_mode_and_reenters_on_another_thread():
    with pytest.raises(ValueError, match="one of"):
        with attn_mod.attention_impl("flash"):
            pass
    seen = {}
    with attn_mod.attention_impl("blocked", q_chunk=64, kv_chunk=16):
        enter = attn_mod.captured_impl()

    def other():
        seen["before"] = attn_mod._ATTN.mode           # thread-local: the default
        with enter():
            seen["inside"] = (attn_mod._ATTN.mode, attn_mod._ATTN.q_chunk,
                              attn_mod._ATTN.kv_chunk)

    th = threading.Thread(target=other)
    th.start()
    th.join()
    assert seen == {"before": "auto", "inside": ("blocked", 64, 16)}


def test_stub_reaches_the_remat_recompute():
    """Under remat "full" the recomputation re-enters the forward's mode: a
    stubbed forward recomputes stubbed (a checkpoint would raise on another
    number of saved tensors otherwise)."""
    from repro_torch.models.lm import init_lm, lm_loss

    cfg = registry.load_config("qwen2-7b", reduced=True)
    params = init_lm(torch.Generator().manual_seed(0), cfg)
    live = [p.requires_grad_(True) for p in tree_leaves(params)]
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator()
                                     .manual_seed(2)),
             "labels": torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator()
                                     .manual_seed(3))}
    with attn_mod.attention_impl("stub"):
        loss = lm_loss(params, batch, cfg, remat="full")
    grads = torch.autograd.grad(loss, live)
    assert all(torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------------------
# compat
# ---------------------------------------------------------------------------


def test_overlap_supported_is_the_references_rule():
    assert compat.overlap_supported("cpu") is ref_compat.overlap_supported("cpu") is False
    assert compat.overlap_supported("cuda") is ref_compat.overlap_supported("gpu") is True
    assert compat.overlap_supported(torch.device("cuda", 0)) is True
    assert compat.overlap_supported() is torch.cuda.is_available()
    assert not hasattr(compat, "enable_overlap_xla_flags")    # XLA flags: no counterpart


@pytest.mark.parametrize("hw", ["pi3-core", "jetson-nano-gpu", "tpu-v5e-chip"])
def test_auto_schedule_resolves_as_the_reference_where_overlap_is_supported(monkeypatch, hw):
    """``_resolve_auto_schedule`` now asks ``compat.overlap_supported``: on a
    card it resolves as the reference's does on a backend that overlaps,
    and on the CPU to sync, as the reference's on its CPU backend."""
    from repro.models.yolo import yolov2_16_layers as ref_layers

    resolve_hw_profile, ref_hw = fusion.resolve_hw_profile, ref_fusion.resolve_hw_profile

    args = ((32, 32), yolov2_16_layers()[:4], None, 2, 2)
    ref_args = ((32, 32), ref_layers()[:4], None, 2, 2)
    assert fusion._resolve_auto_schedule(*args, resolve_hw_profile(hw), 1, None, "cpu") == \
        ref_fusion._resolve_auto_schedule(*ref_args, ref_hw(hw), 1, None) == "sync"
    monkeypatch.setattr(ref_compat, "overlap_supported", lambda backend=None: True)
    assert fusion._resolve_auto_schedule(*args, resolve_hw_profile(hw), 1, None, "cuda") == \
        ref_fusion._resolve_auto_schedule(*ref_args, ref_hw(hw), 1, None)
