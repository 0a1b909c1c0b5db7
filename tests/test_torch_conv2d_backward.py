"""The port's conv backward - dgrad (B2), wgrad (B3) and the autograd
``ops.conv2d`` - on CPU tensors, i.e. their plain versions, against the JAX
Pallas kernels in interpret mode on the same numpy inputs.

Tolerances: the kernels alone at the fp32 kernel bar atol=2e-5, rtol=1e-4
(tests/test_kernels.py:265,278); the padded conv's VJP at atol=rtol=1e-4
(tests/test_kernels.py:248-250).  The CUDA kernels run only on the card,
where ``chip_smoke.py`` holds them against these plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv2d_tiled.backward import conv2d_dgrad_tile as jax_dgrad
from repro.kernels.conv2d_tiled.backward import conv2d_wgrad_tile as jax_wgrad
from repro.kernels.conv2d_tiled.backward import rotate_filter as jax_rotate
from repro.kernels.conv2d_tiled.ops import conv2d as jax_conv2d
from repro_torch.kernels.conv2d_tiled.kernel import (
    WGRAD_BK,
    WGRAD_TILES,
    conv2d_wgrad_tile,
    conv2d_dgrad_tile,
    wgrad_split,
    wgrad_tile,
)
from repro_torch.kernels.conv2d_tiled.ops import conv2d
from repro_torch.kernels.conv2d_tiled.ref import rotate_filter_ref

KERNEL_TOL = dict(atol=2e-5, rtol=1e-4)
VJP_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """The shapes here are tiny and gradcheck repeats them a few hundred
    times: one intra-op thread each, so parallel test workers do not
    oversubscribe the cores (which slowed one gradcheck 300-fold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

# tests/test_kernels.py BWD_CASES
BWD_CASES = [
    # n, h, w, cin, cout, k, stride, pad, act
    (1, 10, 10, 8, 16, 3, 1, 1, "leaky"),
    (2, 17, 17, 3, 32, 3, 2, 0, "linear"),
    (1, 12, 12, 4, 10, 3, 2, 1, "relu"),      # ragged: (12+2-3) % 2 != 0
    (2, 9, 9, 6, 7, 1, 1, 0, "leaky"),        # 1x1 conv, non-128 cout
    (1, 20, 20, 5, 12, 5, 1, 2, "relu"),      # K=5
    (1, 16, 16, 8, 24, 2, 2, 0, "leaky"),     # even kernel, stride 2
]


def _data(case, seed=0):
    n, h, w_, cin, cout, k, s, pad, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w_, cin)).astype(np.float32)
    w = (0.1 * rng.standard_normal((k, k, cin, cout))).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    oh = (h + 2 * pad - k) // s + 1
    ow = (w_ + 2 * pad - k) // s + 1
    g = rng.standard_normal((n, oh, ow, cout)).astype(np.float32)
    return x, w, b, g


def _padded(x, pad):
    return np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c) for c in BWD_CASES])
def test_dgrad_matches_jax_kernel(case):
    *_, k, s, pad, _ = case
    x, w, _, g = _data(case)
    hw = _padded(x, pad).shape[1:3]
    want = np.asarray(jax_dgrad(jnp.asarray(g), jnp.asarray(w), hw, stride=s, interpret=True))
    got = conv2d_dgrad_tile(torch.from_numpy(g), torch.from_numpy(w), hw, stride=s)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


@pytest.mark.parametrize("case", BWD_CASES, ids=[str(c) for c in BWD_CASES])
def test_wgrad_matches_jax_kernel(case):
    *_, k, s, pad, _ = case
    x, w, _, g = _data(case)
    xp = _padded(x, pad)
    want = np.asarray(jax_wgrad(jnp.asarray(xp), jnp.asarray(g), k, stride=s, bc=64,
                                interpret=True))
    got = conv2d_wgrad_tile(torch.from_numpy(xp), torch.from_numpy(g), k, stride=s)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **KERNEL_TOL)


def test_rotate_filter_matches_jax():
    w = np.random.default_rng(1).standard_normal((3, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(rotate_filter_ref(torch.from_numpy(w)).numpy(),
                                  np.asarray(jax_rotate(jnp.asarray(w))))


VJP_CASES = [(act, bias) for act in ("linear", "relu", "leaky") for bias in (True, False)]


@pytest.mark.parametrize("act,bias", VJP_CASES)
@pytest.mark.parametrize("geom", [(1, 1), (2, 1)], ids=["s1p1", "s2p1"])
def test_conv2d_vjp_matches_jax(act, bias, geom):
    s, pad = geom
    case = (2, 11, 11, 4, 9, 3, s, pad, act)
    x, w, b, g = _data(case, seed=3)
    jb = jnp.asarray(b) if bias else None
    y, vjp = jax.vjp(lambda x_, w_, b_: jax_conv2d(x_, w_, b_, s, pad, act, True, None),
                     jnp.asarray(x), jnp.asarray(w), jb)
    want = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True) if bias else None
    out = conv2d(xt, wt, bt, s, pad, act)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), **KERNEL_TOL)
    got = torch.autograd.grad(out, [xt, wt] + ([bt] if bias else []), torch.from_numpy(g))
    for a, ref in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), **VJP_TOL)
    assert (want[2] is None) == (not bias)


@pytest.mark.parametrize("act", ["linear", "leaky"])
@pytest.mark.parametrize("geom", [(1, 1), (2, 0)], ids=["s1p1", "s2p0"])
def test_conv2d_gradcheck_float64(act, geom):
    s, pad = geom
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 7, 6, 2))).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((3, 3, 2, 3))).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal(3)).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda x_, w_, b_: conv2d(x_, w_, b_, s, pad, act),
                                    (x, w, b))


def test_backward_skips_gradients_nobody_wants(monkeypatch):
    """A frozen input or a constant bias costs no dgrad / bias reduction;
    the gradients that are asked for are unchanged."""
    from repro_torch.kernels.conv2d_tiled import ops

    x, w, b, g = _data(BWD_CASES[0])
    gt = torch.from_numpy(g)
    wt = torch.from_numpy(w).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    full = torch.autograd.grad(conv2d(xt, wt, torch.from_numpy(b), 1, 1, "leaky"), [xt, wt], gt)
    calls = []
    real = ops.conv2d_dgrad_tile
    monkeypatch.setattr(ops, "conv2d_dgrad_tile", lambda *a, **k: calls.append(1) or real(*a, **k))
    (dw,) = torch.autograd.grad(
        conv2d(torch.from_numpy(x), wt, torch.from_numpy(b), 1, 1, "leaky"), [wt], gt)
    assert calls == []
    np.testing.assert_array_equal(dw.numpy(), full[1].numpy())


def test_mixed_precision_cotangents_come_back_in_primal_dtypes():
    x, w, b, g = _data(BWD_CASES[2])
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = conv2d(xb, wt, bt, 2, 1, "relu")
    assert y.dtype == torch.float32
    dx, dw, db = torch.autograd.grad(y, [xb, wt, bt], torch.from_numpy(g))
    assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.float32, torch.float32)
    xp = torch.nn.functional.pad(xb.detach(), (0, 0, 1, 1, 1, 1))
    dwb = conv2d_wgrad_tile(xp, torch.from_numpy(g).to(torch.bfloat16), 3, stride=2)
    assert dwb.dtype == torch.bfloat16


def test_wrappers_launch_or_raise_never_fall_back():
    """Off the CPU the wrappers go to the kernel path, which raises here (no
    card); CPU calls run the plain versions and count no launches."""
    before = (conv2d_dgrad_tile.launches, conv2d_wgrad_tile.launches)
    g = torch.empty((1, 3, 3, 4), device="meta")
    w = torch.empty((3, 3, 2, 4), device="meta")
    x = torch.empty((1, 5, 5, 2), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        conv2d_dgrad_tile(g, w, (5, 5))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        conv2d_wgrad_tile(x, g, 3)
    conv2d_dgrad_tile(torch.zeros(1, 3, 3, 4), torch.zeros(3, 3, 2, 4), (5, 5))
    conv2d_wgrad_tile(torch.zeros(1, 5, 5, 2), torch.zeros(1, 3, 3, 4), 3)
    assert (conv2d_dgrad_tile.launches, conv2d_wgrad_tile.launches) == before
    with pytest.raises(ValueError, match="inconsistent"):
        conv2d_dgrad_tile(torch.zeros(1, 4, 4, 4), torch.zeros(3, 3, 2, 4), (5, 5))
    with pytest.raises(ValueError, match="positive"):
        conv2d_wgrad_tile(torch.zeros(1, 5, 5, 2), torch.zeros(1, 3, 3, 4), 3, stride=0)


# (pixels N*OH*OW, filter rows K*K*Cin, Cout) of the YOLOv2-16 training convs at
# 416x416 on a 2x2 grid, microbatch of 4 (16 tiles), grouping (0-3)(4-7)(8-11)(12-15)
TRAIN_WGRAD = [(16 * 212 * 212, 27, 32), (16 * 104 * 104, 288, 64), (16 * 54 * 54, 576, 128),
               (16 * 54 * 54, 128, 64), (16 * 28 * 28, 1152, 256), (16 * 15 * 15, 2304, 512),
               (16 * 13 * 13, 512, 256)]


@pytest.mark.parametrize("pixels,rows,cout", TRAIN_WGRAD + [(7, 9, 1), (16, 64, 64), (5000, 4608, 512)])
def test_wgrad_split_covers_the_reduction(pixels, rows, cout):
    splits, chunk = wgrad_split(pixels, rows, cout)
    assert splits >= 1 and chunk % WGRAD_BK == 0
    assert (splits - 1) * chunk < pixels <= splits * chunk       # every slice non-empty
    assert wgrad_split(pixels, rows, cout) == (splits, chunk)     # shape alone decides
    _, bm, bn, _ = WGRAD_TILES[wgrad_tile(rows, cout)]
    blocks = splits * -(-rows // bm) * -(-cout // bn)
    if (pixels, rows, cout) in TRAIN_WGRAD:
        assert blocks >= 300, blocks            # a few hundred blocks for a 132-SM card


@pytest.mark.parametrize("rows,cout,want", [
    (27, 32, "32x32"),          # the first layer: 3x3x3 filter rows, 32 channels
    (32, 32, "32x32"),
    (27, 64, "128x64"),
    (288, 64, "128x64"),
    (128, 64, "128x64"),
    (9, 1, "32x32"),
    (576, 128, "128x128"),
    (2304, 512, "128x128"),
    (512, 256, "128x128"),
])
def test_wgrad_tile_is_a_function_of_the_output_shape(rows, cout, want):
    assert wgrad_tile(rows, cout) == want
    _, bm, bn, threads = WGRAD_TILES[want]
    assert bm % 4 == 0 and bn % 4 == 0 and threads % 32 == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tile_case", [
    ((2, 14, 13, 3), (3, 3, 3, 5), 2),          # 32x32, Cin 3: 4-byte gathers
    ((2, 20, 20, 32), (3, 3, 32, 64), 1),       # 128x64, 16-byte gathers
    ((2, 12, 12, 64), (3, 3, 64, 96), 1),       # 128x128, ragged Cout
    ((3, 19, 23, 5), (3, 3, 5, 70), 2),         # 128x128, odd Cin
], ids=["32x32", "128x64", "128x128", "128x128-odd-cin"])
def test_wgrad_tiles_on_the_card(tile_case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py there")
    xs, ws, s = tile_case
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (xs[0], (xs[1] - ws[0]) // s + 1, (xs[2] - ws[0]) // s + 1, ws[3])).astype(np.float32))
    want = conv2d_wgrad_tile(x, g, ws[0], stride=s)
    got = conv2d_wgrad_tile(x.cuda(), g.cuda(), ws[0], stride=s)
    assert torch.equal(got, conv2d_wgrad_tile(x.cuda(), g.cuda(), ws[0], stride=s))
    assert float((got.cpu() - want).abs().max()) <= 1e-3 * float(want.abs().max())
