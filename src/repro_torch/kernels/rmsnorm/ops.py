"""RMSNorm op for the models: the CUDA kernel (B6) forward, a plain backward.

As ``repro/kernels/rmsnorm/ops.py``: the forward is the kernel (its plain
version on the CPU), and the backward is autograd through ``rmsnorm_ref``
on the saved inputs - the reference's ``custom_vjp`` recomputes through XLA
the same way, and has no backward kernel to port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import kernel as _kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _kernel.rmsnorm(x.contiguous(), scale, eps=eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            x_ = x.detach().requires_grad_(ctx.needs_input_grad[0])
            s_ = scale.detach().requires_grad_(ctx.needs_input_grad[1])
            y = rmsnorm_ref(x_, s_, ctx.eps)
            wrt = [t for t in (x_, s_) if t.requires_grad]
            got = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        dx = next(got) if ctx.needs_input_grad[0] else None
        ds = next(got) if ctx.needs_input_grad[1] else None
        return dx, ds, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _RMSNorm.apply(x, scale, eps)
