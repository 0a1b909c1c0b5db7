"""The port's flash attention (B4) against the JAX package on the CPU.

- the port's op and wrapper (their plain version on a CPU tensor) against
  the Pallas kernel in interpret mode (bq = bk = 64) on every ``FA_CASES``
  entry of ``tests/test_kernels.py``, at that file's ``_tol``;
- the op's gradients (its backward recomputes through ``_sdpa_blocked``)
  against the JAX op's (whose backward does the same in XLA), atol 1e-4;
- the plain ``_sdpa_naive`` / ``_sdpa_blocked`` / ``_sdpa`` against the
  reference's, with offset positions, windows and cache validity masks.
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
from repro_torch.kernels.flash_attention.ref import attention_ref, scaled_q
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
