"""The port's flash attention (B4) against the JAX package on the CPU.

- the port's op and wrapper (their plain version on a CPU tensor) against
  the Pallas kernel in interpret mode (bq = bk = 64) on every ``FA_CASES``
  entry of ``tests/test_kernels.py``, at that file's ``_tol``;
- the op's gradients (its backward recomputes through ``_sdpa_blocked``)
  against the JAX op's (whose backward does the same in XLA), atol 1e-4;
- the plain ``_sdpa_naive`` / ``_sdpa_blocked`` / ``_sdpa`` against the
  reference's, with offset positions, windows and cache validity masks;
- an emulation of the bf16 tensor-core instance's roundings (``_tc_emulation``)
  against ``attention_ref`` and the Pallas kernel on every ``FA_CASES`` shape in
  bf16, at the bf16 bar, and the wrapper's instance rule (a pure function of
  dtype and head dim).
Inputs are drawn with numpy and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_fwd as jax_fa_fwd
from repro.kernels.flash_attention.ops import flash_attention as jax_fa_op
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref, scaled_q
from repro_torch.models import attention as tattn

FA_CASES = [         # tests/test_kernels.py:30
    # b, tq, tk, hq, hkv, dh, causal, window, dtype
    (2, 128, 128, 4, 4, 64, True, None, "float32"),
    (1, 256, 256, 8, 2, 64, True, None, "float32"),      # GQA 4x
    (1, 256, 256, 4, 1, 128, True, 96, "float32"),       # MQA + window
    (2, 128, 128, 4, 4, 64, False, None, "float32"),     # bidirectional
    (1, 192, 192, 4, 2, 64, True, None, "float32"),      # non-pow2 T
    (1, 128, 128, 4, 4, 64, True, None, "bfloat16"),
    (1, 128, 256, 4, 4, 64, False, None, "float32"),     # cross-length
]
GRAD_ATOL = 1e-4     # tests/test_kernels.py:73


def _tol(dt: str) -> dict:     # tests/test_kernels.py:22
    return dict(atol=2e-3, rtol=2e-2) if dt == "bfloat16" else dict(atol=2e-5, rtol=1e-4)


def _qkv(case, seed=0):
    b, tq, tk, hq, hkv, dh, *_ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, np.float32)
            for s in ((b, tq, hq, dh), (b, tk, hkv, dh), (b, tk, hkv, dh))]


def _both(arrays, dt: str):
    return ([jnp.asarray(a, getattr(jnp, dt)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dt)) for a in arrays])


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.mark.parametrize("case", FA_CASES, ids=[str(c[:8]) for c in FA_CASES])
def test_flash_attention_matches_pallas_interpret(case):
    causal, window, dt = case[6:]
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(case), dt)
    want = np.asarray(jax_fa_fwd(qj, kj, vj, causal=causal, window=window, bq=64, bk=64,
                                 interpret=True), np.float32)
    before = tkernel.flash_attention_fwd.launches
    got = flash_attention(qt, kt, vt, causal, window, None, 64, 64)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), want, **_tol(dt))
    direct = tkernel.flash_attention_fwd(qt, kt, vt, causal=causal, window=window, bq=64, bk=64)
    np.testing.assert_allclose(_np(direct), want, **_tol(dt))
    assert tkernel.flash_attention_fwd.launches == before     # CPU: the plain version


GRAD_CASES = [FA_CASES[i] for i in (1, 2, 3, 6)] + [
    (1, 128, 128, 4, 2, 64, True, None, "float32"),    # tests/test_kernels.py:57
]


@pytest.mark.parametrize("case", GRAD_CASES, ids=[str(c[:8]) for c in GRAD_CASES])
def test_flash_attention_grads_match_jax_op(case):
    causal, window, _ = case[6:]
    q, k, v = _qkv(case, seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape, np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(jax_fa_op(q_, k_, v_, causal, window, None, 64, 64, True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    (flash_attention(*ts, causal, window, None, 64, 64) * torch.from_numpy(g)).sum().backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_ATOL)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 128])
def test_scaled_q_rounds_like_jax(dt, dh):
    """JAX multiplies a q of type bf16 by a Python float in bf16 (a weakly
    typed scalar): the scale is rounded to bf16 first - at Dh = 128 it is
    not exact - and so is the product.  The port's ``scaled_q`` (used by the
    plain versions; the kernel's wrapper rounds the scale the same way)
    gives the same bits."""
    a = np.random.default_rng(3).standard_normal((4, 33, 2, dh), np.float32)
    (qj,), (qt,) = _both([a], dt)
    want = np.asarray((qj * dh ** -0.5).astype(jnp.float32))
    got = scaled_q(qt, dh ** -0.5)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _positions(b, t, offset):
    return (np.arange(t, dtype=np.int32)[None] + offset * np.arange(b, dtype=np.int32)[:, None])


SDPA_CASES = [
    # b, tq, tk, hq, hkv, dh, causal, window, q_chunk, kv_chunk, pos offset, k_valid
    (2, 64, 64, 4, 2, 16, True, None, 16, 32, 0, False),
    (2, 48, 48, 4, 1, 32, True, 20, 16, 16, 5, False),
    (1, 40, 80, 2, 2, 16, False, None, 1024, 16, 0, False),
    (2, 32, 32, 4, 2, 16, True, None, 8, 8, 3, True),
]


@pytest.mark.parametrize("case", SDPA_CASES, ids=[str(c) for c in SDPA_CASES])
def test_plain_sdpa_modes_match_reference(case):
    b, tq, tk, hq, hkv, dh, causal, window, qc, kc, off, valid = case
    q, k, v = _qkv((b, tq, tk, hq, hkv, dh), seed=4)
    qp = _positions(b, tq, off) + (tk - tq)
    kp = _positions(b, tk, off)
    kv = (np.random.default_rng(5).random((b, tk)) > 0.3) if valid else None
    if kv is not None:
        kv[:, 0] = True
    jargs = [jnp.asarray(a) for a in (q, k, v, qp, kp)]
    targs = [torch.from_numpy(a) for a in (q, k, v, qp, kp)]
    jkw = dict(causal=causal, window=window, k_valid=None if kv is None else jnp.asarray(kv))
    tkw = dict(causal=causal, window=window, k_valid=None if kv is None else torch.from_numpy(kv))
    pairs = [
        (jattn._sdpa_naive(*jargs, **jkw), tattn._sdpa_naive(*targs, **tkw)),
        (jattn._sdpa_blocked(*jargs, **jkw, q_chunk=qc, kv_chunk=kc),
         tattn._sdpa_blocked(*targs, **tkw, q_chunk=qc, kv_chunk=kc)),
        (jattn._sdpa(*jargs, **jkw), tattn._sdpa(*targs, **tkw)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(_np(got), np.asarray(want), **_tol("float32"))


def test_plain_sdpa_blocked_grads_match_reference():
    b, t, hq, hkv, dh = 1, 64, 4, 2, 16
    q, k, v = _qkv((b, t, t, hq, hkv, dh), seed=6)
    pos = np.arange(t, dtype=np.int32)

    def jloss(q_, k_, v_):
        out = jattn._sdpa_blocked(q_, k_, v_, pos, pos, causal=True, window=24,
                                  q_chunk=16, kv_chunk=32)
        return jnp.sum(out ** 2)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    p = torch.from_numpy(pos)
    (tattn._sdpa_blocked(*ts, p, p, causal=True, window=24, q_chunk=16, kv_chunk=32) ** 2).sum() \
        .backward()
    for t_, w in zip(ts, want):
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(w), atol=GRAD_ATOL)


@pytest.mark.parametrize("t,c", [(2048, 1024), (192, 64), (100, 64), (96, 1024), (17, 512)])
def test_pick_chunk_matches_reference(t, c):
    assert tattn._pick_chunk(t, c) == jattn._pick_chunk(t, c)


def test_flash_attention_never_takes_the_plain_path_off_the_cpu():
    """Only CPU tensors take the plain version; anything else launches the
    kernel or raises (a meta tensor stands in for a device tensor)."""
    q = torch.empty((1, 8, 2, 16), device="meta")
    k = torch.empty((1, 8, 1, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="Hq a multiple"):
        tkernel.flash_attention_fwd(torch.ones(1, 8, 3, 16), torch.ones(1, 8, 2, 16),
                                    torch.ones(1, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        tkernel.flash_attention_fwd(torch.ones(1, 8, 2, 16), torch.ones(1, 8, 1, 16),
                                    torch.ones(1, 8, 1, 16), window=0)


@pytest.mark.cuda
def test_flash_attention_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py there")
    for case in FA_CASES:
        causal, window, dt = case[6:]
        qt, kt, vt = _both(_qkv(case), dt)[1]
        got = tkernel.flash_attention_fwd(qt.cuda(), kt.cuda(), vt.cuda(), causal=causal,
                                          window=window)
        want = attention_ref(qt, kt, vt, causal=causal, window=window)
        torch.testing.assert_close(got.cpu().float(), want.float(), **_tol(dt))


TC_TILE = 128        # the tensor-core instance's query rows per CTA and keys per stage
TC_ROWS = 64         # query rows per consumer warpgroup
TC_HALF = 64         # keys per online-softmax step (half a stage)


def _tc_emulation(q, k, v, causal, window, scale=None, p_terms=2, out_dtype=torch.bfloat16):
    """What the bf16 tensor-core instance computes, in torch on the CPU: each
    CTA's ``TC_TILE`` query rows walk the same KV stages of ``TC_TILE`` keys
    (those wholly above the diagonal or outside the window skipped), each
    warpgroup's ``TC_ROWS`` rows take a stage in halves of ``TC_HALF`` keys
    (halves past Tk or above all its rows skipped), S from bf16 operands
    summed in fp32, the online softmax in fp32, P split into ``p_terms`` bf16
    terms (the kernel: 2, p = hi + lo; FA2 / FA3: 1) before P·V, l summed
    from the fp32 p, the output rounded to ``out_dtype`` (the kernel: bf16)."""
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    qf = scaled_q(q, dh ** -0.5 if scale is None else scale)   # rounded to bf16, as fp32
    kf = k.float().repeat_interleave(hq // hkv, dim=2)
    vf = v.float().repeat_interleave(hq // hkv, dim=2)
    out = torch.empty(b, tq, hq, dh)
    for q0 in range(0, tq, TC_TILE):
        k_end = min(tk, q0 + TC_TILE, tq) if causal else tk
        first = q0 - window + 1 if window is not None else 0
        k_begin = first // TC_TILE * TC_TILE if first > 0 else 0
        for r0 in range(q0, min(q0 + TC_TILE, tq), TC_ROWS):
            rows = torch.arange(r0, min(r0 + TC_ROWS, tq))
            row_hi = r0 + TC_ROWS - 1
            m = torch.full((b, hq, len(rows)), NEG_INF)
            l = torch.zeros(b, hq, len(rows))
            acc = torch.zeros(b, hq, len(rows), dh)
            for k0 in (h for t in range(k_begin, k_end, TC_TILE)
                       for h in range(t, t + TC_TILE, TC_HALF)):
                if k0 >= tk or (causal and k0 > row_hi):
                    continue
                keys = torch.arange(k0, k0 + TC_HALF)
                real = keys < tk
                kt = torch.zeros(b, TC_HALF, hq, dh)
                vt = torch.zeros(b, TC_HALF, hq, dh)
                kt[:, real], vt[:, real] = kf[:, keys[real]], vf[:, keys[real]]
                s = torch.einsum("bqhd,bkhd->bhqk", qf[:, rows], kt)
                ok = real[None, :].expand(len(rows), -1)
                if causal:
                    ok = ok & (rows[:, None] >= keys[None, :])
                if window is not None:
                    ok = ok & (rows[:, None] - keys[None, :] < window)
                s = torch.where(ok, s, NEG_INF)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None]
                rest = p
                for _ in range(p_terms):
                    term = rest.to(torch.bfloat16).float()
                    acc = acc + torch.einsum("bhqk,bkhd->bhqd", term, vt)
                    rest = rest - term
                m = m_new
            out[:, rows] = (acc / torch.clamp(l, min=1e-30)[..., None]).permute(0, 2, 1, 3)
    return out.to(out_dtype)


BF16_CASES = [c[:8] + ("bfloat16",) for c in FA_CASES]


# A power-of-two softmax scale, exact in bf16 with every product q*scale: at
# the default 1/sqrt(Dh) of Dh 128 the Pallas kernel interpreted by XLA on the
# CPU keeps q*scale in excess precision (it may skip the rounding to bf16 that
# JAX's eager multiply, the TPU kernel's stated semantics and the port make),
# which alone moves some outputs of the seeded inputs past the bf16 bar.
EXACT_SCALE = 0.125


@pytest.mark.parametrize("case", BF16_CASES, ids=[str(c[:8]) for c in BF16_CASES])
def test_tensor_core_roundings_meet_the_bf16_bar(case):
    """The tensor-core instance's roundings (bf16 S operands, fp32 sums, P as
    bf16 hi + lo, bf16 output) against the plain version at the default
    scale and against the Pallas kernel at ``EXACT_SCALE``, at the bf16 bar;
    and, before the output's own rounding, P in two bf16 terms lands at
    least 16x closer to an fp64 evaluation of the same rounded q*scale than P
    in one (the kernel's reason for the second term)."""
    causal, window, dt = case[6:]
    (qj, kj, vj), (qt, kt, vt) = _both(_qkv(case, seed=7), dt)
    got = _tc_emulation(qt, kt, vt, causal, window)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    plain = attention_ref(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(plain), **_tol(dt))
    want = np.asarray(jax_fa_fwd(qj, kj, vj, causal=causal, window=window, scale=EXACT_SCALE,
                                 bq=64, bk=64, interpret=True), np.float32)
    np.testing.assert_allclose(_np(_tc_emulation(qt, kt, vt, causal, window, EXACT_SCALE)), want,
                               **_tol(dt))
    qs = scaled_q(qt, qt.shape[-1] ** -0.5).double()
    exact = attention_ref(qs, kt.double(), vt.double(), causal=causal, window=window, scale=1.0)
    err2, err1 = ((_tc_emulation(qt, kt, vt, causal, window, p_terms=n, out_dtype=torch.float32)
                   .double() - exact).abs().max() for n in (2, 1))
    assert 16 * err2 <= err1, (err2, err1)


def test_tensor_core_emulation_walks_the_kernel_tiles():
    """A masked half met first (a window's first walked stage can lie wholly
    outside a later row's window) gives p = exp(0) = 1 there, and alpha = 0
    wipes it when a real key arrives: the emulation, walking the kernel's
    stages and halves, meets the bf16 bar against the plain version."""
    case = (1, 384, 384, 2, 1, 64, True, 96, "bfloat16")
    _, (qt, kt, vt) = _both(_qkv(case, seed=8), "bfloat16")
    got = _tc_emulation(qt, kt, vt, True, 96)
    np.testing.assert_allclose(_np(got), _np(attention_ref(qt, kt, vt, causal=True, window=96)),
                               **_tol("bfloat16"))


INSTANCE_RULE = [
    (torch.float32, 64, "simt_fp32_dh64"),
    (torch.float32, 16, "simt_fp32_dh64"),
    (torch.float32, 65, "simt_fp32_dh128"),
    (torch.float32, 128, "simt_fp32_dh128"),
    (torch.bfloat16, 64, "wgmma_bf16_dh64"),
    (torch.bfloat16, 40, "wgmma_bf16_dh64"),
    (torch.bfloat16, 96, "wgmma_bf16_dh128"),
    (torch.bfloat16, 128, "wgmma_bf16_dh128"),
]


@pytest.mark.parametrize("dtype,dh,want", INSTANCE_RULE,
                         ids=[f"{d}-{h}" for d, h, _ in INSTANCE_RULE])
def test_instance_rule_is_a_function_of_dtype_and_head_dim(dtype, dh, want):
    assert tkernel.fa_instance(dtype, dh) == want
    assert want in tkernel.INSTANCES


@pytest.mark.parametrize("dtype,dh,err,match", [
    (torch.bfloat16, 12, ValueError, "multiple of 8"),     # TMA: 24-byte rows
    (torch.float32, 129, ValueError, "head dim"),
    (torch.bfloat16, 0, ValueError, "head dim"),
    (torch.float16, 64, TypeError, "float32 or bfloat16"),
])
def test_instance_rule_raises_with_the_reason(dtype, dh, err, match):
    with pytest.raises(err, match=match):
        tkernel.fa_instance(dtype, dh)


def test_launch_counts_split_by_instance_and_reset():
    tkernel.flash_attention_fwd.launches_by_instance["wgmma_bf16_dh128"] += 3
    tkernel.flash_attention_fwd.launches += 3
    tkernel.reset_launches()
    assert tkernel.flash_attention_fwd.launches == 0
    assert tkernel.flash_attention_fwd.launches_by_instance == dict.fromkeys(tkernel.INSTANCES, 0)


TC_CARD_CASES = BF16_CASES + [
    (1, 200, 200, 4, 2, 128, True, None, "bfloat16"),      # Dh 128, ragged T
    (1, 100, 300, 4, 2, 128, True, None, "bfloat16"),      # Tq < Tk
    (1, 512, 512, 14, 2, 128, True, 96, "bfloat16"),       # window 96, GQA 7x
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CARD_CASES, ids=[str(c[:8]) for c in TC_CARD_CASES])
def test_tensor_core_instance_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py there")
    causal, window, dt = case[6:]
    qt, kt, vt = _both(_qkv(case), dt)[1]
    tkernel.reset_launches()
    got = tkernel.flash_attention_fwd(qt.cuda(), kt.cuda(), vt.cuda(), causal=causal,
                                      window=window)
    assert tkernel.flash_attention_fwd.launches_by_instance[
        tkernel.fa_instance(qt.dtype, qt.shape[-1])] == 1
    want = attention_ref(qt, kt, vt, causal=causal, window=window)
    torch.testing.assert_close(got.cpu().float(), want.float(), **_tol(dt))
