"""The port's ``conv2d_tile`` on CPU tensors - its plain version - against
the JAX Pallas kernel in interpret mode, on the same numpy inputs.  fp32
tolerance atol=2e-5, rtol=1e-4 (tests/test_kernels.py).  The CUDA kernel
itself runs only on the card: ``chip_smoke.py`` holds it against the plain
version there.  Here the tests also pin that a non-CPU tensor never falls
back to the plain version, B1's tile, split-K and gather rules at every
YOLOv2-16 path shape, and B1's summation order (split-K slices, one
running FMA sum a slice, bias and activation once after the reduce),
emulated on the CPU, against the Pallas kernel and the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.conv2d_tiled.kernel import conv2d_tile as jax_conv2d_tile
from repro.kernels.conv2d_tiled.ops import conv2d as jax_conv2d
from repro_torch.core.backend import get_conv_backend, pad_for_valid
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_tiled.kernel import (
    FWD_BK,
    FWD_TILES,
    conv2d_tile,
    fwd_gather,
    fwd_split,
    fwd_tile,
)
from repro_torch.kernels.conv2d_tiled.ops import conv2d
from repro_torch.kernels.conv2d_tiled.ref import conv2d_ref

TOL = dict(atol=2e-5, rtol=1e-4)

CASES = [
    # n, h, w, cin, cout, k, stride, act, bias, block_oh
    (2, 10, 10, 3, 8, 3, 1, "linear", False, None),
    (1, 12, 9, 5, 7, 3, 1, "relu", True, None),      # Cout not a multiple of bc
    (2, 11, 11, 4, 70, 3, 2, "leaky", True, None),   # stride 2, Cout > bc=64
    (1, 9, 9, 6, 16, 1, 1, "leaky", False, None),    # 1x1
    (2, 13, 10, 3, 5, 3, 1, "leaky", True, 2),       # block_oh 2
    (1, 14, 14, 8, 9, 3, 2, "relu", False, 3),       # block_oh 3, stride 2
    (1, 8, 8, 2, 1, 3, 1, "linear", True, 1),        # Cout = 1
]


def _inputs(case, seed=0):
    n, h, w, cin, cout, k, _, _, bias, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32) if bias else None
    return x, wt, b


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_conv2d_tile_matches_jax(case):
    *_, stride, act, _, block_oh = case
    x, w, b = _inputs(case)
    want = np.asarray(jax_conv2d_tile(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        stride=stride, act=act, bc=64, block_oh=block_oh, interpret=True,
    ))
    got = conv2d_tile(_t(x), _t(w), _t(b), stride=stride, act=act, bc=64, block_oh=block_oh)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv2d_tile_mixed_precision_promotes():
    x, w, b = _inputs(CASES[1])
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = conv2d_tile(xb, _t(w), _t(b), act="relu")
    assert got.dtype == torch.float32
    both = conv2d_tile(xb, _t(w).to(torch.bfloat16), None)
    assert both.dtype == torch.bfloat16
    want = np.asarray(jax_conv2d_tile(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), jnp.asarray(w),
        jnp.asarray(b), act="relu", bc=64, interpret=True,
    ))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("pad", [0, 1])
def test_padded_wrapper_matches_jax_ops(pad):
    x, w, b = _inputs(CASES[2])
    want = np.asarray(jax_conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1, pad,
                                 "leaky", True, None))
    got = conv2d(_t(x), _t(w), _t(b), 1, pad, "leaky")
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_padded_wrapper_is_forward_only():
    """The name is kept from when the wrapper had no backward.  Since its
    backward kernels (B2/B3) were ported, its backward runs their plain
    versions on the CPU and gives the gradients of torch's own padded conv -
    an oracle independent of the JAX VJP that test_torch_conv2d_backward.py
    holds it against."""
    x, w, b = _inputs(CASES[0])
    xt = _t(x).requires_grad_(True)
    wt = _t(w).requires_grad_(True)
    y = conv2d(xt, wt, None, 1, 1, "linear")
    y.sum().backward()
    xr = _t(x).requires_grad_(True)
    wr = _t(w).requires_grad_(True)
    F.conv2d(xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1), padding=1).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), wr.grad.numpy(), **TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_backends_match_jax_pallas_backend(backend):
    """Both port backends against the reference's pallas backend (which adds
    a zero bias for b=None, as the cuda backend does)."""
    from repro.core.backend import get_conv_backend as jax_backend

    x, w, _ = _inputs(CASES[2])
    want = np.asarray(jax_backend("pallas")(jnp.asarray(x), jnp.asarray(w), None,
                                            stride=2, act="leaky"))
    got = get_conv_backend(backend)(_t(x), _t(w), None, stride=2, act="leaky", block_oh=2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_pad_for_valid_matches_jax():
    from repro.core.backend import pad_for_valid as jax_pad

    x = np.random.default_rng(3).standard_normal((1, 3, 4, 2)).astype(np.float32)
    for pool in (False, True):
        np.testing.assert_array_equal(
            pad_for_valid(_t(x), 2, pool=pool).numpy(), np.asarray(jax_pad(jnp.asarray(x), 2, pool=pool))
        )


def test_non_cpu_tensor_launches_or_raises_never_falls_back():
    """A tensor off the CPU goes to the kernel path, which raises here (no
    card) instead of quietly running the plain version."""
    before = conv2d_tile.launches
    x = torch.empty((1, 5, 5, 3), device="meta")
    w = torch.empty((3, 3, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        conv2d_tile(x, w)
    assert conv2d_tile.launches == before
    # CPU calls run the plain version and do not count as launches
    conv2d_tile(torch.zeros(1, 5, 5, 3), torch.zeros(3, 3, 3, 4))
    assert conv2d_tile.launches == before


def test_kernel_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    assert _build.library_path("conv2d_tile").parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")


def test_bad_activation_and_stride_rejected():
    x, w, _ = _inputs(CASES[0])
    with pytest.raises(ValueError, match="activation"):
        conv2d_tile(_t(x), _t(w), act="gelu")
    with pytest.raises(ValueError, match="positive"):
        conv2d_tile(_t(x), _t(w), stride=0)
    with pytest.raises(ValueError):
        conv2d_ref(_t(x), _t(w), act="swish")


# --- B1's tile, split and gather rules (kernel.py) ---------------------------

# (x shape, w shape) of the 12 YOLOv2-16 convs at 416x416 on a 2x2 grid,
# grouping (0-3)(4-7)(8-11)(12-15), per tile-image (the batch dimension is
# 4 x the images): the serve path's bucket 8 is 32 tile-images, the train
# path's microbatch of 4 is 16
_PATH_CONVS = [((214, 214, 3), (3, 3, 3, 32)), ((106, 106, 32), (3, 3, 32, 64)),
               ((56, 56, 64), (3, 3, 64, 128)), ((54, 54, 128), (1, 1, 128, 64)),
               ((54, 54, 64), (3, 3, 64, 128)), ((30, 30, 128), (3, 3, 128, 256)),
               ((28, 28, 256), (1, 1, 256, 128)), ((28, 28, 128), (3, 3, 128, 256)),
               ((17, 17, 256), (3, 3, 256, 512)), ((15, 15, 512), (1, 1, 512, 256)),
               ((15, 15, 256), (3, 3, 256, 512)), ((13, 13, 512), (1, 1, 512, 256))]
PATH_FWD = [((n, *xs), ws) for n in (32, 16) for xs, ws in _PATH_CONVS]


def _gemm_shape(xs, ws, stride=1):
    """(pixels N*OH*OW, Cout, K*K*Cin) of B1's GEMM."""
    n, h, w, cin = xs
    k, _, _, cout = ws
    return n * ((h - k) // stride + 1) * ((w - k) // stride + 1), cout, k * k * cin


@pytest.mark.parametrize("xs,ws", PATH_FWD, ids=[f"{x}x{w}" for x, w in PATH_FWD])
def test_every_path_conv_gets_the_designed_tile_split_and_gather(xs, ws):
    """128 x 128 for Cout > 64, 128 x 64 for Cout = 64, the narrow 128 x 32
    for Cout = 32: no idle columns on the path; the vector gather wherever
    Cin is a multiple of the stage (all but the Cin = 3 image layer); a
    split only where the output tiles leave half of a two-blocks-per-SM
    wave empty, and then no more blocks than that one wave."""
    pixels, cout, kd = _gemm_shape(xs, ws)
    tile = fwd_tile(cout)
    assert tile == {32: "128x32", 64: "128x64"}.get(cout, "128x128")
    _, bm, bn, threads = FWD_TILES[tile]
    assert cout % bn == 0
    assert fwd_gather(xs[-1]) == ("general" if xs[-1] == 3 else "vector")
    splits, _ = fwd_split(pixels, cout, kd)
    tiles = -(-pixels // bm) * (cout // bn)
    wave = 2 * 132 * 256 // threads               # two resident blocks per SM
    assert (splits > 1) == (2 * tiles <= wave)
    assert splits * tiles <= max(wave, tiles)


def test_the_split_path_shapes_are_the_1x1_tail():
    """At bucket 8 only the two last 1x1 convs split (114 and 86 output
    tiles of 128 x 128 on 132 SMs); at microbatch 4 the 1x1 conv at 28 x 28
    and the last four convs do."""
    split = {(xs, ws): fwd_split(*_gemm_shape(xs, ws))[0] for xs, ws in PATH_FWD}
    assert [xs[1:3] for (xs, ws), s in split.items() if s > 1 and xs[0] == 32] == \
        [(15, 15), (13, 13)]
    assert [xs[1:3] for (xs, ws), s in split.items() if s > 1 and xs[0] == 16] == \
        [(28, 28), (17, 17), (15, 15), (15, 15), (13, 13)]


@pytest.mark.parametrize("pixels,cout,kd", [_gemm_shape(xs, ws) for xs, ws in PATH_FWD] + [
    (1, 1, 1), (7, 3, 9), (175, 256, 2304), (969, 130, 360), (100000, 32, 27), (64, 70, 16),
    (5, 600, 100000), (3, 1, 0)])
def test_fwd_split_covers_the_reduction_once(pixels, cout, kd):
    """Every term of the K*K*Cin reduction lands in exactly one slice: the
    slices are whole stages, none is empty, and the rule depends on the
    shape alone (an empty reduction is one slice of no stages)."""
    splits, chunk = fwd_split(pixels, cout, kd)
    assert splits >= 1 and chunk >= FWD_BK and chunk % FWD_BK == 0
    assert fwd_split(pixels, cout, kd) == (splits, chunk)
    if kd == 0:
        assert splits == 1
        return
    assert (splits - 1) * chunk < kd <= splits * chunk
    if splits > 1:
        assert chunk // FWD_BK >= 8                     # _FWD_MIN_STAGES


@pytest.mark.parametrize("cout,want", [(1, "128x32"), (30, "128x32"), (32, "128x32"),
                                       (33, "128x64"), (64, "128x64"), (65, "128x128"),
                                       (130, "128x128"), (512, "128x128")])
def test_fwd_tile_is_a_function_of_cout(cout, want):
    assert fwd_tile(cout) == want
    _, bm, bn, threads = FWD_TILES[want]
    assert bm == 128 and threads % 32 == 0 and bn * 128 // threads in (16, 32, 64)


@pytest.mark.parametrize("cin,want", [(3, "general"), (5, "general"), (24, "general"),
                                      (0, "general"), (16, "vector"), (32, "vector"),
                                      (512, "vector")])
def test_fwd_gather_is_a_function_of_cin(cin, want):
    assert fwd_gather(cin) == want


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 fused multiply-add: the product and sum taken in fp64 (a product
    of two fp32 values is exact there) and rounded once to fp32."""
    return (a.double() * b.double() + c.double()).float()


def _b1_walk(x: torch.Tensor, w: torch.Tensor, b, stride: int, act: str) -> torch.Tensor:
    """B1's summation order, emulated in fp32 on the CPU: the GEMM
    y[m, co] = sum_k A[m, k] B[k, co] over the whole batch's output pixels
    with k = (ki*K + kj)*Cin + ci; each slice of ``fwd_split`` is one running
    FMA sum in k order; the slices are added in slice order, then the bias,
    then the activation - once, after the reduce."""
    n, h, wd, cin = x.shape
    k, _, _, cout = w.shape
    oh, ow = (h - k) // stride + 1, (wd - k) // stride + 1
    cols = [x[:, ki:ki + stride * (oh - 1) + 1:stride, kj:kj + stride * (ow - 1) + 1:stride]
            for ki in range(k) for kj in range(k)]
    a = torch.stack(cols, dim=3).reshape(n * oh * ow, k * k * cin)
    bm = w.reshape(k * k * cin, cout)
    kd = k * k * cin
    splits, chunk = fwd_split(n * oh * ow, cout, kd)
    y = None
    for s in range(splits):
        acc = torch.zeros((n * oh * ow, cout), dtype=torch.float32)
        for t in range(s * chunk, min(kd, (s + 1) * chunk)):
            acc = _fma32(a[:, t:t + 1], bm[t][None, :], acc)
        y = acc if y is None else y + acc
    if b is not None:
        y = y + b[None, :]
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "leaky":
        y = torch.where(y > 0, y, 0.1 * y)
    return y.reshape(n, oh, ow, cout)


# (x shape, w shape, stride, act, bias): split four ways with bias and leaky
# after the reduce; a 1x1 split two ways; the general gather split; stride 2;
# no split
B1_WALK_CASES = [
    ((1, 6, 6, 64), (3, 3, 64, 40), 1, "leaky", True),
    ((2, 5, 5, 256), (1, 1, 256, 72), 1, "relu", True),
    ((1, 7, 6, 40), (3, 3, 40, 130), 1, "leaky", True),
    ((1, 9, 9, 32), (3, 3, 32, 16), 2, "linear", False),
    ((1, 5, 5, 5), (3, 3, 5, 7), 1, "leaky", True),
]


@pytest.mark.parametrize("case", B1_WALK_CASES, ids=[str(c) for c in B1_WALK_CASES])
def test_b1_walk_matches_plain_and_pallas(case):
    xs, ws, stride, act, bias = case
    rng = np.random.default_rng(17)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) * (2.0 / (ws[0] * ws[1] * ws[2])) ** 0.5).astype(np.float32)
    b = rng.standard_normal(ws[-1]).astype(np.float32) if bias else None
    pixels, cout, kd = _gemm_shape(xs, ws, stride)
    if case != B1_WALK_CASES[-1]:
        assert fwd_split(pixels, cout, kd)[0] > 1 or stride == 2
    got = _b1_walk(_t(x), _t(w), _t(b), stride, act)
    plain = conv2d_tile(_t(x), _t(w), _t(b), stride=stride, act=act)
    pallas = np.asarray(jax_conv2d_tile(jnp.asarray(x), jnp.asarray(w),
                                        None if b is None else jnp.asarray(b), stride=stride,
                                        act=act, bc=64, interpret=True))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ((3, 21, 19, 16), (3, 3, 16, 30), 1, "relu"),        # 128x32, vector, ragged Cout
    ((2, 11, 13, 48), (3, 3, 48, 50), 1, "leaky"),       # 128x64, vector, split
    ((3, 21, 19, 40), (3, 3, 40, 130), 1, "leaky"),      # 128x128, general, split
    ((5, 9, 7, 256), (3, 3, 256, 256), 1, "leaky"),      # 128x128, vector, split ragged M
    ((3, 19, 23, 5), (3, 3, 5, 70), 2, "leaky"),         # odd Cin, stride 2
], ids=["128x32", "128x64-split", "128x128-general-split", "128x128-split-ragged-m",
        "odd-cin-stride2"])
def test_b1_tiles_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py there")
    xs, ws, s, act = case
    x, w, b = _inputs((xs[0], xs[1], xs[2], xs[3], ws[3], ws[0], s, act, True, None), seed=9)
    want = conv2d_tile(_t(x), _t(w), _t(b), stride=s, act=act)
    got = conv2d_tile(_t(x).cuda(), _t(w).cuda(), _t(b).cuda(), stride=s, act=act)
    assert torch.equal(got, conv2d_tile(_t(x).cuda(), _t(w).cuda(), _t(b).cuda(), stride=s,
                                        act=act))
    torch.testing.assert_close(got.cpu(), want, **TOL)
