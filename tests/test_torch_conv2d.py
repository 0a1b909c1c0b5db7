"""The port's ``conv2d_tile`` on CPU tensors - its plain version - against
the JAX Pallas kernel in interpret mode, on the same numpy inputs.  fp32
tolerance atol=2e-5, rtol=1e-4 (tests/test_kernels.py).  The CUDA kernel
itself runs only on the card: ``chip_smoke.py`` holds it against the plain
version there.  Here the tests also pin that a non-CPU tensor never falls
back to the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.conv2d_tiled.kernel import conv2d_tile as jax_conv2d_tile
from repro.kernels.conv2d_tiled.ops import conv2d as jax_conv2d
from repro_torch.core.backend import get_conv_backend, pad_for_valid
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_tiled.kernel import conv2d_tile
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
