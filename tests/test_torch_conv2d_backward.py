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
from repro_torch.kernels.conv2d_tiled.backward import dgrad_gather
from repro_torch.kernels.conv2d_tiled.kernel import (
    DGRAD_BK,
    DGRAD_TILES,
    WGRAD_BK,
    WGRAD_TILES,
    conv2d_wgrad_tile,
    conv2d_dgrad_tile,
    dgrad_split,
    dgrad_tile,
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


# --- B2's tile, split and summation order (backward.py) ---------------------

# (dx pixels N*H*W, Cin, K*K*Cout, Cout) of the 11 YOLOv2-16 training dgrads at
# 416x416 on a 2x2 grid, microbatch of 4 (16 tiles), grouping (0-3)(4-7)(8-11)(12-15)
TRAIN_DGRAD = [(16 * 106 * 106, 32, 576, 64), (16 * 56 * 56, 64, 1152, 128),
               (16 * 54 * 54, 128, 64, 64), (16 * 54 * 54, 64, 1152, 128),
               (16 * 30 * 30, 128, 2304, 256), (16 * 28 * 28, 256, 128, 128),
               (16 * 28 * 28, 128, 2304, 256), (16 * 17 * 17, 256, 4608, 512),
               (16 * 15 * 15, 512, 256, 256), (16 * 15 * 15, 256, 4608, 512),
               (16 * 13 * 13, 512, 256, 256)]


@pytest.mark.parametrize("pixels,cin,kd,cout", TRAIN_DGRAD, ids=[str(c) for c in TRAIN_DGRAD])
def test_every_path_dgrad_gets_the_designed_tile_and_gather(pixels, cin, kd, cout):
    """128 x 128 for Cin >= 128, 128 x 64 for Cin = 64, the narrow 128 x 32
    for Cin = 32; every path conv is stride 1 with Cout a multiple of the
    stage, so it takes the gather without division."""
    want = {32: "128x32", 64: "128x64"}.get(cin, "128x128")
    assert dgrad_tile(cin) == want
    _, _, bn, threads = DGRAD_TILES[want]
    assert cin % bn == 0 and threads % 32 == 0          # no idle columns on the path
    assert dgrad_gather(cout, 1) == "stride1"


@pytest.mark.parametrize("pixels,cin,kd", [c[:3] for c in TRAIN_DGRAD] + [
    (315, 32, 4608), (1, 1, 1), (7, 3, 9), (100000, 3, 288), (64, 70, 16), (5, 600, 100000)])
def test_dgrad_split_covers_the_reduction_once(pixels, cin, kd):
    """Every term of the K*K*Cout reduction lands in exactly one slice: the
    slices are whole stages, none is empty, and the rule depends on the shape
    alone."""
    splits, chunk = dgrad_split(pixels, cin, kd)
    assert splits >= 1 and chunk >= DGRAD_BK and chunk % DGRAD_BK == 0
    assert (splits - 1) * chunk < kd <= splits * chunk
    assert dgrad_split(pixels, cin, kd) == (splits, chunk)
    if splits > 1:
        assert chunk // DGRAD_BK >= 8                   # _DGRAD_MIN_STAGES


@pytest.mark.parametrize("pixels,cin,kd,cout", TRAIN_DGRAD, ids=[str(c) for c in TRAIN_DGRAD])
def test_dgrad_split_puts_a_block_on_every_sm(pixels, cin, kd, cout):
    """Every path shape puts at least one block on each of the 132 SMs."""
    splits, _ = dgrad_split(pixels, cin, kd)
    _, bm, bn, _ = DGRAD_TILES[dgrad_tile(cin)]
    assert splits * -(-pixels // bm) * -(-cin // bn) >= 132


@pytest.mark.parametrize("cout,stride,want", [
    (64, 1, "stride1"), (512, 1, "stride1"), (16, 1, "stride1"),
    (70, 1, "general"), (1, 1, "general"), (24, 1, "general"), (64, 2, "general")])
def test_dgrad_gather_is_a_function_of_cout_and_stride(cout, stride, want):
    assert dgrad_gather(cout, stride) == want


def _b2_walk(g: torch.Tensor, w: torch.Tensor, in_hw, stride: int) -> torch.Tensor:
    """B2's summation order, emulated in fp32 on the CPU: the GEMM
    dx[m, ci] = sum_k A[m, k] B[ci, k] with k = (ki*K + kj)*Cout + co; each
    slice of ``dgrad_split`` sums its stages of ``DGRAD_BK`` terms, each stage
    on its own before it joins the slice's total, and the slices are added
    in slice order."""
    n, oh, ow, cout = g.shape
    k, _, cin, _ = w.shape
    h, wd = in_hw
    a = torch.zeros((n, h, wd, k, k, cout), dtype=torch.float32)
    for ki in range(k):
        for kj in range(k):
            a[:, ki:ki + stride * (oh - 1) + 1:stride, kj:kj + stride * (ow - 1) + 1:stride,
              ki, kj] = g
    kd = k * k * cout
    a = a.reshape(n * h * wd, kd)
    b = w.permute(2, 0, 1, 3).reshape(cin, kd)
    splits, chunk = dgrad_split(n * h * wd, cin, kd)
    dx = None
    for s in range(splits):
        acc = torch.zeros((n * h * wd, cin), dtype=torch.float32)
        end = min(kd, (s + 1) * chunk)
        for k0 in range(s * chunk, end, DGRAD_BK):
            st = torch.zeros_like(acc)
            for t in range(k0, min(k0 + DGRAD_BK, end)):
                st = st + a[:, t:t + 1] * b[:, t][None, :]
            acc = acc + st
        dx = acc if dx is None else dx + acc
    return dx.reshape(n, h, wd, cin)


# (g shape, w shape, in_hw, stride): split-K over stride 1; stride 2 with a
# ragged row; a 1x1 conv; stride 2 split three ways
WALK_CASES = [
    ((2, 7, 7, 64), (3, 3, 40, 64), (9, 9), 1),
    ((2, 4, 4, 48), (3, 3, 8, 48), (10, 9), 2),
    ((3, 5, 6, 96), (1, 1, 24, 96), (5, 6), 1),
    ((1, 5, 5, 64), (3, 3, 16, 64), (11, 11), 2),
]


@pytest.mark.parametrize("case", WALK_CASES, ids=[str(c) for c in WALK_CASES])
def test_b2_walk_matches_plain_and_pallas_and_is_no_farther_from_fp64(case):
    gs, ws, hw, s = case
    rng = np.random.default_rng(11)
    g = rng.standard_normal(gs).astype(np.float32)
    w = (0.1 * rng.standard_normal(ws)).astype(np.float32)
    kd = ws[0] * ws[1] * ws[3]
    assert kd >= 2 * DGRAD_BK                        # at least two stages
    got = _b2_walk(torch.from_numpy(g), torch.from_numpy(w), hw, s)
    plain = conv2d_dgrad_tile(torch.from_numpy(g), torch.from_numpy(w), hw, stride=s)
    pallas = np.asarray(jax_dgrad(jnp.asarray(g), jnp.asarray(w), hw, stride=s, interpret=True))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **KERNEL_TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **KERNEL_TOL)
    exact = conv2d_dgrad_tile(torch.from_numpy(g).double(), torch.from_numpy(w).double(), hw,
                              stride=s)
    walk64 = float((got.double() - exact).abs().max())
    plain64 = float((plain.double() - exact).abs().max())
    assert walk64 <= plain64, (walk64, plain64)


def test_backward_module_is_the_kernel_modules_backward():
    """C.4: B2 and B3 live in backward.py, as in the reference; kernel.py
    re-exports the same objects (one launch counter per function)."""
    from repro_torch.kernels.conv2d_tiled import backward, kernel
    from repro_torch.kernels.conv2d_tiled.ops import conv2d_dgrad_tile as ops_dgrad

    for name in ("conv2d_dgrad_tile", "conv2d_wgrad_tile", "wgrad_tile", "wgrad_split",
                 "dgrad_tile", "dgrad_split", "rotate_filter", "WGRAD_TILES", "DGRAD_TILES"):
        assert getattr(kernel, name) is getattr(backward, name)
    assert ops_dgrad is backward.conv2d_dgrad_tile
    w = np.random.default_rng(1).standard_normal((3, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(backward.rotate_filter(torch.from_numpy(w)).numpy(),
                                  np.asarray(jax_rotate(jnp.asarray(w))))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_case", [
    ((3, 21, 19, 32), (3, 3, 32, 48), 1),       # 128x32, stride 1
    ((2, 11, 13, 40), (3, 3, 40, 48), 1),       # 128x64, ragged Cin
    ((3, 21, 19, 96), (3, 3, 96, 64), 1),       # 128x128, ragged Cin
    ((2, 17, 17, 96), (3, 3, 96, 64), 2),       # 128x128, general gather
    ((5, 9, 7, 32), (3, 3, 32, 512), 1),        # split-K over a ragged M
], ids=["128x32", "128x64", "128x128", "128x128-stride2", "split-ragged-m"])
def test_dgrad_tiles_on_the_card(tile_case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py there")
    xs, ws, s = tile_case
    rng = np.random.default_rng(9)
    w = torch.from_numpy((0.1 * rng.standard_normal(ws)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (xs[0], (xs[1] - ws[0]) // s + 1, (xs[2] - ws[0]) // s + 1, ws[3])).astype(np.float32))
    want = conv2d_dgrad_tile(g, w, xs[1:3], stride=s)
    got = conv2d_dgrad_tile(g.cuda(), w.cuda(), xs[1:3], stride=s)
    assert torch.equal(got, conv2d_dgrad_tile(g.cuda(), w.cuda(), xs[1:3], stride=s))
    torch.testing.assert_close(got.cpu(), want, **KERNEL_TOL)
