"""The port's SSD intra-chunk scan (B5) against the JAX package on the CPU.

The port's wrapper takes its plain version for CPU tensors.  Inputs are
drawn with numpy and handed to both packages; the float64 evaluation is the
port's plain path in float64.

- The intra-chunk kernel: on every ``SSD_CASES`` entry of
  ``tests/test_kernels.py``, fp32 and bf16 inputs (upcast exactly), against
  the Pallas kernel in interpret mode and the reference's plain version at
  that file's fp32 bar (atol 2e-5, rtol 1e-4), element by element.  On the
  T < chunk case (one chunk of 96) the two packages' fp32 sums differ by up
  to 1.05x that bar at one element of 12288 while each is within 0.62x of
  it from float64; there both are held to the bar against float64.
- The scan op (B5 + the cross-chunk combine, plain backward): the
  reference's own test case element by element - y and the final state at
  the fp32 bar, the x-gradient at its gradient bar (atol 5e-4, rtol 1e-3).
  On every case, each output and the gradient of each of the five inputs
  normwise (max |err| <= rtol x max |want|, rtol 1e-4 forward, 1e-3
  gradients) against JAX's ``ops.ssd_scan`` and ``_ssd_chunk_scan`` and
  against float64.  Element by element the dt, B and C gradients of fp32
  evaluations miss the gradient bar against float64 in both packages
  (JAX's dt-gradient by 2x on the first case): they sum many large terms
  that cancel.
- A float64 ``gradcheck`` of the op.
- The repair (ROADMAP C.1): once a chunk's total log-decay passes -88.7,
  fp32 ``exp`` overflows above the diagonal and the reference's dt- and
  A-gradients are non-finite (already on ``SSD_CASES[2]``, whose own test
  checks only the x-gradient); the port's forward is the reference's and
  its gradients are finite and close to float64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ops as jops
from repro.kernels.ssd_chunk.kernel import ssd_chunk_fwd as jax_ssd_chunk_fwd
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models.mamba2 import _ssd_chunk_scan as jax_ssd_chunk_scan
from repro_torch.kernels.ssd_chunk import kernel as tkernel
from repro_torch.kernels.ssd_chunk.ops import ssd_scan, ssd_scan_ref
from repro_torch.kernels.ssd_chunk.ref import causal_decay, ssd_chunk_ref
from repro_torch.models.mamba2 import _ssd_chunk_scan

SSD_CASES = [        # tests/test_kernels.py:456
    # b, t, h, p, g, n, chunk
    (2, 128, 4, 16, 2, 8, 32),
    (1, 64, 2, 8, 1, 4, 64),      # single chunk, no GQA-style groups
    (1, 256, 8, 32, 2, 16, 64),
]
SHORT_CASE = (2, 96, 4, 16, 1, 8, 256)      # T < chunk: one chunk of 96
ALL_CASES = SSD_CASES + [SHORT_CASE]
TOL = dict(atol=2e-5, rtol=1e-4)            # tests/test_kernels.py:478
GRAD_TOL = dict(atol=5e-4, rtol=1e-3)       # tests/test_kernels.py:500
NAMES = ("x", "dt", "A", "B", "C")


def _inputs(case, seed=0, a_scale=0.3, a_mean=0.0):
    """numpy inputs as in tests/test_kernels.py: dt = softplus(N(0, 1)),
    A = -exp(a_mean + a_scale N(0, 1))."""
    b, t, h, p, g, n, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, t, h)), 0.0).astype(np.float32)
    A = -np.exp(a_mean + a_scale * rng.standard_normal(h)).astype(np.float32)
    Bm = rng.standard_normal((b, t, g, n), np.float32)
    Cm = rng.standard_normal((b, t, g, n), np.float32)
    return x, dt, A, Bm, Cm


def _to_dtype(arrs, dt):
    """x, B, C in ``dt`` for both packages (bf16 rounds to nearest even in
    both); dt and A stay fp32."""
    x, d, A, Bm, Cm = arrs
    jx = [jnp.asarray(x, dt), jnp.asarray(d), jnp.asarray(A), jnp.asarray(Bm, dt),
          jnp.asarray(Cm, dt)]
    td = getattr(torch, dt)
    tx = [torch.from_numpy(x).to(td), torch.from_numpy(d), torch.from_numpy(A),
          torch.from_numpy(Bm).to(td), torch.from_numpy(Cm).to(td)]
    return jx, tx


def _f64(tx, chunk):
    return [a.numpy() for a in ssd_chunk_ref(*[t.double() for t in tx], chunk=chunk)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ALL_CASES, ids=[str(c) for c in ALL_CASES])
def test_ssd_chunk_matches_pallas_interpret_and_ref(case, dt):
    chunk = case[-1]
    jx, tx = _to_dtype(_inputs(case), dt)
    want_k = jax_ssd_chunk_fwd(*jx, chunk=chunk, interpret=True)
    want_r = jax_ssd_chunk_ref(*jx, chunk=chunk)
    before = tkernel.ssd_chunk_fwd.launches
    got = tkernel.ssd_chunk_fwd(*tx, chunk=chunk)
    assert tkernel.ssd_chunk_fwd.launches == before      # CPU: the plain version
    nc = case[1] // min(chunk, case[1])
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want_r]
    assert got[1].shape[1] == nc and all(g.dtype == torch.float32 for g in got)
    wants = [want_k, want_r]
    if case == SHORT_CASE:
        exact = _f64(tx, chunk)
        wants = [exact]
        for w in (want_k, want_r):
            for name, a, b_ in zip(("y", "S", "decay", "pref"), w, exact):
                np.testing.assert_allclose(np.asarray(a), b_, **TOL, err_msg=name)
    for w in wants:
        for name, g, b_ in zip(("y", "S", "decay", "pref"), got, w):
            np.testing.assert_allclose(g.numpy(), np.asarray(b_), **TOL, err_msg=name)


def _grads_jax(fn, jx, r):
    def loss(*a):
        y, fin = fn(*a)
        return jnp.sum(y.astype(jnp.float32) ** 2) + jnp.sum(fin * r)

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jx)


def _grads_torch(fn, tx, r):
    live = [t.clone().requires_grad_(True) for t in tx]
    y, fin = fn(*live)
    (torch.sum(y.float() ** 2) + torch.sum(fin * r)).backward()
    return y.detach(), fin.detach(), [t.grad for t in live]


def _normwise(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("case", ALL_CASES, ids=[str(c) for c in ALL_CASES])
def test_ssd_scan_matches_jax_op_and_model_scan(case):
    chunk = case[-1]
    q = min(chunk, case[1])
    jx, tx = _to_dtype(_inputs(case, seed=1), "float32")
    b, t, h, p, g, n, _ = case
    r = np.random.default_rng(2).standard_normal((b, h, n, p)).astype(np.float32)
    rt = torch.from_numpy(r)
    jax_fns = (lambda *a: jops.ssd_scan(*a, chunk, True), lambda *a: jax_ssd_chunk_scan(*a, chunk=q))
    jax_out = [[np.asarray(o) for o in fn(*jx)] for fn in jax_fns]
    jax_grads = [[np.asarray(o) for o in _grads_jax(fn, jx, jnp.asarray(r))] for fn in jax_fns]
    y64, fin64, g64 = _grads_torch(lambda *a: ssd_scan_ref(*a, chunk), [u.double() for u in tx],
                                   rt.double())
    cum_min = float(np.cumsum(np.asarray(jx[1]).reshape(b, -1, q, h) * np.asarray(jx[2]),
                              axis=2).min())
    for fn in (lambda *a: ssd_scan(*a, chunk), lambda *a: _ssd_chunk_scan(*a, q)):
        y, fin, grads = _grads_torch(fn, tx, rt)
        assert y.dtype == torch.float32 and fin.shape == (b, h, n, p)
        for (want_y, want_f), want_g in zip(jax_out, jax_grads):
            if case == SSD_CASES[0]:          # tests/test_kernels.py:484's own checks
                np.testing.assert_allclose(y.numpy(), want_y, **TOL)
                np.testing.assert_allclose(fin.numpy(), want_f, **TOL)
                np.testing.assert_allclose(grads[0].numpy(), want_g[0], **GRAD_TOL)
            for got, w, w64 in ((y, want_y, y64), (fin, want_f, fin64)):
                assert _normwise(got, w) <= TOL["rtol"] and _normwise(got, w64) <= TOL["rtol"]
            for name, got, w, w64 in zip(NAMES, grads, want_g, g64):
                assert torch.isfinite(got).all(), name
                assert _normwise(got, w64) <= GRAD_TOL["rtol"], name
                if np.isfinite(w).all():
                    assert _normwise(got, w) <= GRAD_TOL["rtol"], name
                else:   # the reference's fault: exp overflows above the diagonal
                    assert name in ("dt", "A") and cum_min < -88.7, name


def test_ssd_scan_keeps_x_type_and_grads_of_a_subset():
    """bf16 x gives a bf16 y; grads only for the inputs that ask, equal to
    differentiating the plain scan."""
    case = SSD_CASES[0]
    _, tx = _to_dtype(_inputs(case, seed=3), "bfloat16")
    x, dt, A, Bm, Cm = tx
    y, fin = ssd_scan(x, dt, A, Bm, Cm, case[-1])
    assert y.dtype == torch.bfloat16 and fin.dtype == torch.float32
    for wants in ((True, False, False, False, False), (False, True, True, False, True)):
        live = [t.clone().requires_grad_(w) for t, w in zip(tx, wants)]
        ref = [t.clone().requires_grad_(w) for t, w in zip(tx, wants)]
        ssd_scan(*live, case[-1])[0].float().sum().backward()
        ssd_scan_ref(*ref, case[-1])[0].float().sum().backward()
        for a, b_ in zip(live, ref):
            assert (a.grad is None) == (b_.grad is None)
            if a.grad is not None:
                assert torch.equal(a.grad, b_.grad)


def test_ssd_scan_gradcheck_float64():
    case = (1, 12, 4, 3, 2, 5, 4)
    x, dt, A, Bm, Cm = (torch.from_numpy(a).double().requires_grad_(True)
                        for a in _inputs(case, seed=4))

    def fn(*a):
        y, fin = ssd_scan(*a, 4)
        return y, fin

    assert torch.autograd.gradcheck(fn, (x, dt, A, Bm, Cm), eps=1e-6, atol=1e-5)


def test_masked_decay_is_the_reference_forward_bit_for_bit():
    """exp(where(tri, d, -inf)) selects the same exp(d) as the reference's
    where(tri, exp(d), 0), above-diagonal overflow included."""
    rng = np.random.default_rng(5)
    da = -np.abs(rng.standard_normal((3, 256))).astype(np.float32) * 2.0
    cum = torch.from_numpy(np.cumsum(da, axis=-1, dtype=np.float32))
    assert float(cum.min()) < -88.7                   # exp overflows above the diagonal
    dseg = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((256, 256), dtype=torch.bool).tril()
    literal = torch.where(tri, torch.exp(dseg), torch.zeros(()))
    assert not torch.isfinite(torch.exp(dseg)).all()
    assert torch.equal(causal_decay(cum), literal)


def _overflow_inputs():
    """One 256-token chunk, dt = softplus(N(0, 1)), A = -1: the chunk's
    total log-decay reaches about -180, past fp32 exp's -88.7."""
    case = (1, 256, 2, 8, 1, 8, 256)
    arrs = _inputs(case, seed=6, a_scale=0.0)
    cum_end = np.cumsum(arrs[1] * arrs[2], axis=1)[:, -1]
    assert float(cum_end.max()) < -88.7
    return case, arrs


def test_reference_dt_grad_is_not_finite_past_exp_overflow():
    """The reference's fault, documented: its forward is finite, its fp32
    dt-gradient is not (0 * inf in the where's backward)."""
    case, arrs = _overflow_inputs()
    jx, _ = _to_dtype(arrs, "float32")
    y, fin = jax_ssd_chunk_scan(*jx, chunk=256)
    assert np.isfinite(np.asarray(y)).all() and np.isfinite(np.asarray(fin)).all()
    r = jnp.asarray(np.random.default_rng(7).standard_normal(fin.shape).astype(np.float32))
    for fn in (lambda *a: jax_ssd_chunk_scan(*a, chunk=256),
               lambda *a: jops._ref_scan(*a, 256)):
        g = _grads_jax(fn, jx, r)
        assert np.isfinite(np.asarray(g[0])).all()                 # x
        assert not np.isfinite(np.asarray(g[1])).all()             # dt


def test_port_grads_are_finite_and_match_float64_past_exp_overflow():
    case, arrs = _overflow_inputs()
    jx, tx = _to_dtype(arrs, "float32")
    r = np.random.default_rng(7).standard_normal((1, 2, 8, 8)).astype(np.float32)
    y, fin, grads = _grads_torch(lambda *a: ssd_scan(*a, 256), tx, torch.from_numpy(r))
    # the forward is the reference's
    y_j, fin_j = jax_ssd_chunk_scan(*jx, chunk=256)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(fin.detach().numpy(), np.asarray(fin_j), **TOL)
    # the gradients are finite and close to the plain path in float64
    _, _, g64 = _grads_torch(lambda *a: ssd_scan_ref(*a, 256), [t.double() for t in tx],
                             torch.from_numpy(r).double())
    for name, g, w in zip(NAMES, grads, g64):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), **GRAD_TOL, err_msg=name)


def test_ssd_chunk_fwd_checks_its_inputs():
    """Only a CPU tensor takes the plain version (a meta tensor stands in
    for a device tensor); shapes the reference asserts on raise."""
    m = dict(device="meta")
    args = (torch.empty((1, 64, 2, 8), **m), torch.empty((1, 64, 2), **m),
            torch.empty((2,), **m), torch.empty((1, 64, 1, 4), **m), torch.empty((1, 64, 1, 4), **m))
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.ssd_chunk_fwd(*args, chunk=32)
    _, tx = _to_dtype(_inputs((1, 96, 4, 8, 2, 4, 64)), "float32")
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tkernel.ssd_chunk_fwd(*tx, chunk=64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ssd_scan(*tx, 64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        _ssd_chunk_scan(*tx, 192)
    bad_g = tx[:3] + [t[:, :, :1].repeat(1, 1, 3, 1) for t in tx[3:]]
    with pytest.raises(ValueError, match="multiple of G"):
        tkernel.ssd_chunk_fwd(*bad_g, chunk=32)


@pytest.mark.cuda
def test_ssd_chunk_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py there")
    for case in ALL_CASES:
        for dt in ("float32", "bfloat16"):
            _, tx = _to_dtype(_inputs(case), dt)
            got = tkernel.ssd_chunk_fwd(*[t.cuda() for t in tx], chunk=case[-1])
            for g, w in zip(got, ssd_chunk_ref(*tx, chunk=case[-1])):
                torch.testing.assert_close(g.cpu(), w, **TOL)
