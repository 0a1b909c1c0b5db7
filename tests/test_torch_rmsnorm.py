"""The port's RMSNorm (B6) against the JAX package on the CPU.

The port's wrapper takes its plain version for CPU tensors; it is held
against the Pallas kernel in interpret mode on every ``RMS_CASES`` entry of
``tests/test_kernels.py`` at that file's ``_tol``, and the op's gradients
against the JAX op's at its bar (atol 1e-4, rtol 1e-3).  Inputs are drawn
with numpy and handed to both packages (bf16 rounds to nearest even in
both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.kernel import rmsnorm as jax_rmsnorm_kernel
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm_op
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch.kernels.rmsnorm import kernel as tkernel
from repro_torch.kernels.rmsnorm.ops import rmsnorm as torch_rmsnorm_op
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models.common import apply_norm, rms_norm

RMS_CASES = [        # tests/test_kernels.py:411
    ((4, 128, 512), "float32"),
    ((1000, 256), "float32"),                # non-multiple rows
    ((2, 64, 1024), "bfloat16"),
    ((7, 384), "float32"),
]


def _tol(dt: str) -> dict:     # tests/test_kernels.py:22
    return dict(atol=2e-3, rtol=2e-2) if dt == "bfloat16" else dict(atol=2e-5, rtol=1e-4)


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of type ``dt``."""
    return jnp.asarray(a, getattr(jnp, dt)), torch.from_numpy(a).to(getattr(torch, dt))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.mark.parametrize("case", RMS_CASES, ids=[str(c) for c in RMS_CASES])
def test_rmsnorm_matches_pallas_interpret(case):
    shape, dt = case
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal(shape, np.float32), dt)
    sj, st = _pair(rng.standard_normal(shape[-1:], np.float32), dt)
    want = np.asarray(jax_rmsnorm_kernel(xj, sj, block_rows=128, interpret=True), np.float32)
    before = tkernel.rmsnorm.launches
    got = tkernel.rmsnorm(xt, st, block_rows=128)
    assert got.dtype == xt.dtype and tuple(got.shape) == shape
    np.testing.assert_allclose(_np(got), want, **_tol(dt))
    np.testing.assert_allclose(_np(torch_rmsnorm_op(xt, st)), want, **_tol(dt))
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert tkernel.rmsnorm.launches == before


@pytest.mark.parametrize("shape", [(32, 256), (3, 5, 384)])
def test_rmsnorm_grads_match_jax_op(shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape, np.float32)
    s = rng.standard_normal(shape[-1:], np.float32)
    g = rng.standard_normal(shape, np.float32)
    want = jax.grad(lambda x_, s_: jnp.sum(jax_rmsnorm_op(x_, s_, 1e-6, True) * g),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(s))
    xt = torch.from_numpy(x).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    (torch_rmsnorm_op(xt, st) * torch.from_numpy(g)).sum().backward()
    for got, w in zip((xt.grad, st.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4, rtol=1e-3)


def test_rmsnorm_op_grads_equal_the_plain_versions():
    """The op's backward is autograd through ``rmsnorm_ref``: the same bits
    as differentiating the plain version, for x alone, scale alone, both."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((6, 40), np.float32))
    s = torch.from_numpy(rng.standard_normal((40,), np.float32))
    for need in ((True, True), (True, False), (False, True)):
        a = [t.clone().requires_grad_(n) for t, n in zip((x, s), need)]
        b = [t.clone().requires_grad_(n) for t, n in zip((x, s), need)]
        (torch_rmsnorm_op(*a) ** 2).sum().backward()
        (rmsnorm_ref(*b) ** 2).sum().backward()
        for ta, tb, n in zip(a, b, need):
            assert (ta.grad is None) == (not n)
            if n:
                assert torch.equal(ta.grad, tb.grad)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_model_rms_norm_matches_jax(dt):
    rng = np.random.default_rng(4)
    xj, xt = _pair(rng.standard_normal((8, 64, 128), np.float32), dt)
    sj, st = _pair(1 + 0.1 * rng.standard_normal((128,), np.float32), dt)
    want = np.asarray(jax_rms_norm(xj, sj), np.float32)
    np.testing.assert_allclose(_np(rms_norm(xt, st)), want, **_tol(dt))
    np.testing.assert_allclose(_np(apply_norm("rmsnorm", xt, {"scale": st})), want, **_tol(dt))


def test_rmsnorm_keeps_float64():
    x = torch.randn(4, 16, dtype=torch.float64)
    y = rmsnorm_ref(x, torch.ones(16, dtype=torch.float64))
    want = x / torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
    assert y.dtype == torch.float64 and torch.allclose(y, want, rtol=1e-14, atol=0)


def test_rmsnorm_never_takes_the_plain_path_off_the_cpu():
    """Only a CPU tensor takes the plain version; anything else must launch
    the kernel or raise (a meta tensor stands in for a device tensor)."""
    x = torch.empty((4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.rmsnorm(x, torch.empty((8,), device="meta"))
    with pytest.raises(ValueError, match="block_rows"):
        tkernel.rmsnorm(torch.ones(2, 8), torch.ones(8), block_rows=0)


@pytest.mark.cuda
def test_rmsnorm_kernel_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py there")
    rng = np.random.default_rng(5)
    for shape, dt in RMS_CASES + [((4096, 3584), "bfloat16")]:
        x = torch.from_numpy(rng.standard_normal(shape, np.float32)).to(getattr(torch, dt))
        s = torch.from_numpy(rng.standard_normal(shape[-1:], np.float32)).to(getattr(torch, dt))
        got = tkernel.rmsnorm(x.cuda(), s.cuda())
        torch.testing.assert_close(got.cpu().float(), rmsnorm_ref(x, s).float(), **_tol(dt))


# --- B6's instances (kernel.py:rms_instance) ---------------------------------

# (x type, scale type, D) -> instance: the LM path's widths (Qwen2-7B's 3584,
# Mamba2-780m's 1536 and 3072) in bf16 keep the row in registers with
# 16-byte accesses; fp32 rows that wide, and mixed types whose scale doubles
# the bytes a lane holds, read x twice; widths that are not a multiple of the
# 16-byte vector take the scalar instance
RMS_INSTANCE_CASES = [
    ("bfloat16", "bfloat16", 3584, "warp_regs16"),
    ("bfloat16", "bfloat16", 1536, "warp_regs8"),
    ("bfloat16", "bfloat16", 3072, "warp_regs16"),
    ("bfloat16", "bfloat16", 4096, "warp_regs16"),
    ("bfloat16", "bfloat16", 4104, "warp_stream"),
    ("float32", "float32", 3584, "warp_stream"),
    ("float32", "float32", 2048, "warp_regs16"),
    ("float32", "float32", 512, "warp_regs4"),
    ("float32", "float32", 384, "warp_regs4"),
    ("bfloat16", "float32", 1536, "warp_regs8"),
    ("bfloat16", "float32", 3584, "warp_stream"),
    ("float32", "bfloat16", 1536, "warp_regs16"),
    ("bfloat16", "bfloat16", 100, "warp_scalar"),
    ("bfloat16", "bfloat16", 7, "warp_scalar"),
    ("float32", "float32", 6, "warp_scalar"),
    ("float32", "bfloat16", 1, "warp_scalar"),
]


@pytest.mark.parametrize("xdt,sdt,d,want", RMS_INSTANCE_CASES,
                         ids=[f"{x}-{s}-{d}" for x, s, d, _ in RMS_INSTANCE_CASES])
def test_rms_instance_is_a_function_of_types_and_width(xdt, sdt, d, want):
    xt, st = getattr(torch, xdt), getattr(torch, sdt)
    assert tkernel.rms_instance(xt, st, d) == want
    assert want in tkernel.INSTANCES
    # an unaligned base takes the scalar instance, whatever the width
    assert tkernel.rms_instance(xt, st, d, aligned=False) == "warp_scalar"


@pytest.mark.parametrize("xdt,sdt,d", [(x, s, d) for x, s, d, w in RMS_INSTANCE_CASES
                                       if w.startswith("warp_regs")])
def test_register_instances_hold_at_most_512_bytes_a_lane(xdt, sdt, d):
    """The cut-off: a lane's x and scale vectors of the row take at most 128
    registers; wider rows take the stream instance."""
    xt, st = getattr(torch, xdt), getattr(torch, sdt)
    nv = int(tkernel.rms_instance(xt, st, d)[len("warp_regs"):])
    vec = 16 // xt.itemsize
    assert -(-d // vec // 32) <= nv
    assert nv * (16 + vec * st.itemsize) <= 512


def test_launch_counts_reset_by_instance():
    tkernel.reset_launches()
    assert tkernel.rmsnorm.launches == 0
    assert tkernel.rmsnorm.launches_by_instance == dict.fromkeys(tkernel.INSTANCES, 0)
    tkernel.rmsnorm(torch.ones(2, 8), torch.ones(8))        # a CPU tensor: no launch
    assert sum(tkernel.rmsnorm.launches_by_instance.values()) == tkernel.rmsnorm.launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,xdt,sdt,offset", [
    ((64, 3584), "bfloat16", "bfloat16", 0),    # warp_regs16
    ((64, 1536), "bfloat16", "bfloat16", 0),    # warp_regs8
    ((33, 1000), "bfloat16", "bfloat16", 0),    # warp_regs4
    ((16, 3584), "float32", "float32", 0),      # warp_stream
    ((7, 100), "bfloat16", "bfloat16", 0),      # warp_scalar: width
    ((5, 384), "float32", "float32", 1),        # warp_scalar: unaligned base
    ((16, 1536), "bfloat16", "float32", 0),     # mixed types
])
def test_every_instance_on_the_card(shape, xdt, sdt, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run chip_smoke.py there")
    rng = np.random.default_rng(6)
    n = int(np.prod(shape))
    x = torch.from_numpy(rng.standard_normal(n + offset, np.float32)).to(getattr(torch, xdt))
    s = torch.from_numpy(rng.standard_normal(shape[-1:], np.float32)).to(getattr(torch, sdt))
    xc = x.cuda()[offset:].view(shape)
    got = tkernel.rmsnorm(xc, s.cuda())
    want = rmsnorm_ref(x[offset:].view(shape), s)
    out = "bfloat16" if xdt == sdt == "bfloat16" else "float32"
    torch.testing.assert_close(got.cpu().float(), want.float(), **_tol(out))
