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
- The CUDA kernel's instance and head-slab rules (``ssd_instance``,
  ``ssd_slab``), the three-term bf16 split of its tensor-core instance as a
  property test, and that instance's arithmetic emulated on the CPU (bf16
  operands, fp32 products and sums, M and w·x split in three bf16 terms)
  against the Pallas kernel and the plain version at the fp32 bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.ssd_chunk import ops as jops
from repro.kernels.ssd_chunk.kernel import ssd_chunk_fwd as jax_ssd_chunk_fwd
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models.mamba2 import _ssd_chunk_scan as jax_ssd_chunk_scan
from repro_torch.kernels.ssd_chunk import kernel as tkernel
from repro_torch.kernels.ssd_chunk.ops import ssd_scan, ssd_scan_ref
from repro_torch.kernels.ssd_chunk.ref import causal_decay, chunk_len, ssd_chunk_ref
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


# --- the CUDA kernel's instance and slab rules (kernel.py) -------------------

@pytest.mark.parametrize("x_dt,bc_dt,n,p,q,want", [
    ("bfloat16", "bfloat16", 128, 64, 256, "wgmma_bf16"),   # the Mamba2 path
    ("bfloat16", "bfloat16", 8, 16, 32, "wgmma_bf16"),      # SSD_CASES[0]
    ("bfloat16", "bfloat16", 16, 32, 64, "wgmma_bf16"),     # SSD_CASES[2]
    ("bfloat16", "bfloat16", 8, 16, 96, "wgmma_bf16"),      # SHORT_CASE: Q not a multiple of 64
    ("bfloat16", "bfloat16", 4, 8, 64, "simt_fp32"),        # SSD_CASES[1]: N * 2 bytes < 16
    ("bfloat16", "bfloat16", 128, 60, 256, "simt_fp32"),    # P * 2 bytes not a multiple of 16
    ("bfloat16", "bfloat16", 128, 64, 512, "simt_fp32"),    # 8 key tiles: C·Bᵀ past the registers
    ("float32", "float32", 128, 64, 256, "simt_fp32"),      # the fp32 gradient checks
    ("bfloat16", "float32", 128, 64, 256, "simt_fp32"),
    ("float32", "bfloat16", 128, 64, 256, "simt_fp32"),
])
def test_ssd_instance_is_a_function_of_types_and_shapes(x_dt, bc_dt, n, p, q, want):
    assert tkernel.ssd_instance(getattr(torch, x_dt), getattr(torch, bc_dt), n, p, q) == want
    assert set(tkernel.INSTANCES) == {"simt_fp32", "wgmma_bf16"}


@pytest.mark.parametrize("hpg,q,groups,chunks,want", [
    (48, 256, 1, 32, 24),       # Mamba2-780m, 2 x 4096 tokens: 3 x 32 CTAs of 48 heads < 132
    (48, 256, 1, 64, 48),       # twice the tokens: whole groups fill the card
    (48, 256, 1, 1, 1),         # one chunk: the most CTAs there are
    (2, 32, 2, 8, 1),           # SSD_CASES[0]
    (4, 96, 1, 2, 1),           # SHORT_CASE
    (96, 256, 1, 64, 48),       # 96 heads a group: the prefix's shared memory caps the slab
    (96, 64, 1, 64, 48),        # short chunks: whole groups would leave SMs idle
    (96, 64, 1, 128, 96),       # ... and with twice the chunks fill the card (cap 189)
])
def test_ssd_slab_rule(hpg, q, groups, chunks, want):
    """The largest divisor of H/G whose log-decay prefix fits the shared
    memory left beside the tiles and whose grid still puts a CTA on each of
    132 SMs; one head a CTA where no slab does."""
    slab = tkernel.ssd_slab(hpg, q, groups, chunks)
    assert slab == want and hpg % slab == 0
    qp = -(-q // 64) * 64
    assert 8 * slab * (qp + 2) <= tkernel._TC_SLAB_BYTES
    ctas = (-(-q // 128) + 1) * groups * (hpg // slab) * chunks
    bigger = [d for d in range(slab + 1, hpg + 1)
              if hpg % d == 0 and 8 * d * (qp + 2) <= tkernel._TC_SLAB_BYTES]
    if slab > 1:
        assert ctas >= 132
    assert all((-(-q // 128) + 1) * groups * (hpg // d) * chunks < 132 for d in bigger)


def _split3(v: torch.Tensor):
    """The tensor-core instance's split of fp32 values: hi = bf16(v), mid =
    bf16(v - hi), lo = bf16(v - hi - mid), each rounded to nearest even."""
    hi = v.to(torch.bfloat16)
    r = v - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


_BF16_MAX = float(torch.finfo(torch.bfloat16).max)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.floats(min_value=-_BF16_MAX, max_value=_BF16_MAX, allow_nan=False,
                          allow_infinity=False, width=32), min_size=1, max_size=64))
def test_three_bf16_terms_reconstruct_fp32(values):
    """hi + mid + lo is the fp32 value exactly while every term is a normal
    bf16 (|v| >= 2**-110); below that only the lowest term loses bits, by at
    most bf16's smallest subnormal."""
    v = torch.tensor(values, dtype=torch.float32)
    hi, mid, lo = _split3(v)
    back = hi.double() + mid.double() + lo.double()
    exact = v.double()
    normal = exact.abs() >= 2.0**-110
    assert torch.equal(back[normal], exact[normal])
    assert float((back - exact).abs().max()) <= 2.0**-133


@pytest.mark.parametrize("v", [1.0 + 2**-23, -3.0000002, 1e-30, 6.1e-5, 3.3e38, -2**-100,
                               0.0, 2**-126, 1.0 / 3.0])
def test_three_bf16_terms_reconstruct_edge_values(v):
    x = torch.tensor([v], dtype=torch.float32)
    hi, mid, lo = _split3(x)
    assert float(hi.double() + mid.double() + lo.double()) == float(x.double())


def _wgmma_bf16_emulation(x, dt, A, Bm, Cm, chunk):
    """The tensor-core instance's arithmetic on the CPU: cum by sequential
    fp32 adds of the fp32 products dt·A; S = C·Bᵀ once per (batch, chunk,
    group) with bf16 operands (exact products) and fp32 sums; per head
    M = (S·exp(cum_i − cum_j))·dt_j, 0 above the diagonal, split in three
    bf16 terms, y = Σ_terms term·x with fp32 sums; the state from the three
    bf16 terms of w_j·x_j (w_j = exp(cum_Q − cum_j)·dt_j) times B, fp32
    sums."""
    b, t, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = chunk_len(t, chunk)
    nc, rep = t // q, h // g
    xc = x.reshape(b, nc, q, h, p).float()              # bf16 values, exact in fp32
    Bc = Bm.reshape(b, nc, q, g, n).float()
    Cc = Cm.reshape(b, nc, q, g, n).float()
    dtc = dt.reshape(b, nc, q, h).float()
    dA = dtc * A.float()
    cum = torch.empty_like(dA)
    acc = torch.zeros_like(dA[:, :, 0])
    for i in range(q):                                  # one fp32 add at a time
        acc = acc + dA[:, :, i]
        cum[:, :, i] = acc
    S = torch.einsum("bcign,bcjgn->bcgij", Cc, Bc).repeat_interleave(rep, dim=2)
    ci = cum.permute(0, 1, 3, 2)                        # (B, nc, H, Q)
    dt_j = dtc.permute(0, 1, 3, 2)
    tri = torch.ones((q, q), dtype=torch.bool).tril()
    m = torch.where(tri, S * torch.exp(torch.where(tri, ci[..., :, None] - ci[..., None, :],
                                                   float("-inf"))) * dt_j[..., None, :], 0.0)
    y = sum(torch.einsum("bchij,bcjhp->bcihp", term.float(), xc) for term in _split3(m))
    w = torch.exp(ci[..., -1:] - ci) * dt_j             # (B, nc, H, Q)
    wx = w.permute(0, 1, 3, 2)[..., None] * xc          # (B, nc, Q, H, P), fp32 products
    Bh = Bc.repeat_interleave(rep, dim=3)
    state = sum(torch.einsum("bcjhp,bcjhn->bchnp", term.float(), Bh) for term in _split3(wx))
    return y.reshape(b, t, h, p), state, torch.exp(ci[..., -1]), torch.exp(cum).reshape(b, t, h), cum


@pytest.mark.parametrize("case", ALL_CASES, ids=[str(c) for c in ALL_CASES])
def test_wgmma_bf16_arithmetic_matches_pallas_and_plain(case):
    """The emulation against the Pallas kernel in interpret mode and the
    plain version at the fp32 bar.  Its log-decay prefix is bitwise numpy's
    float32 ``add.accumulate`` (sequential fp32 adds, as the card's
    ``torch.cumsum`` and the kernel take them; torch's CPU ``cumsum``
    accumulates in fp64, so the CPU plain version sits within the bar, not
    bitwise), and pref and decay are exp of that prefix bit for bit."""
    chunk = case[-1]
    arrs = _inputs(case)
    jx, tx = _to_dtype(arrs, "bfloat16")
    y, state, decay, pref, cum = _wgmma_bf16_emulation(*tx, chunk=chunk)
    b, t, h, p, g, n, _ = case
    q = min(chunk, t)
    dA = (arrs[1].reshape(b, t // q, q, h) * arrs[2]).astype(np.float32)
    np.testing.assert_array_equal(cum.numpy(), np.add.accumulate(dA, axis=2, dtype=np.float32))
    assert torch.equal(pref, torch.exp(cum).reshape(b, t, h))
    assert torch.equal(decay, torch.exp(cum[:, :, -1]))
    got = (y, state, decay, pref)
    wants = [jax_ssd_chunk_fwd(*jx, chunk=chunk, interpret=True), ssd_chunk_ref(*tx, chunk=chunk)]
    if case == SHORT_CASE:      # as in the test above: the fp32 evaluations against float64
        wants = [_f64(tx, chunk)]
    for want in wants:
        for name, a, w in zip(("y", "S", "decay", "pref"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL, err_msg=name)


@pytest.mark.cuda
def test_ssd_chunk_instances_on_the_card():
    """Each instance on the card against the plain version there, the
    log-decay prefix bit for bit and a rerun bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py there")
    for case in ALL_CASES:
        for dt in ("float32", "bfloat16"):
            _, tx = _to_dtype(_inputs(case), dt)
            cx = [t_.cuda() for t_ in tx]
            got = tkernel.ssd_chunk_fwd(*cx, chunk=case[-1])
            want = ssd_chunk_ref(*cx, chunk=case[-1])
            assert all(torch.equal(a, c) for a, c in zip(got, tkernel.ssd_chunk_fwd(
                *cx, chunk=case[-1])))
            assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
            for a, w in zip(got, want):
                torch.testing.assert_close(a, w, **TOL)
