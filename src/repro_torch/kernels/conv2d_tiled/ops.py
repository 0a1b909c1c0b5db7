"""Padded conv wrapper over the tiled conv kernels (``repro/.../ops.py:conv2d``).

``conv2d`` zero-pads the input and runs the VALID forward kernel (B1) - the
same decomposition the tiled executor uses, where the halo exchange delivers
the padding.  Its backward runs the dgrad (B2) and wgrad (B3) kernels, as
the reference's ``custom_vjp`` does: the forward output is stashed, ``act'``
of the fused epilogue is recovered from it and applied to the cotangent,
dgrad gives the padded input's gradient (cropped to the unpadded input),
wgrad the filter's, and the bias gradient is an fp32 (fp64 for fp64) sum
of the cotangent over batch and space.  Cotangents come back in the primal dtypes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv2d_tiled.backward import conv2d_dgrad_tile, conv2d_wgrad_tile
from repro_torch.kernels.conv2d_tiled.kernel import conv2d_tile


def _act_grad_from_out(y: torch.Tensor, act: str) -> torch.Tensor:
    """act'(pre-activation) recovered from the fused epilogue's *output*:
    relu (y > 0 iff pre > 0; 0 at the kink) and leaky (slope 0.1 > 0, so y
    and pre share their sign)."""
    if act == "relu":
        return (y > 0).to(y.dtype)
    if act == "leaky":
        return torch.where(y > 0, torch.ones((), dtype=y.dtype, device=y.device),
                           torch.full((), 0.1, dtype=y.dtype, device=y.device))
    raise ValueError(f"no fused epilogue gradient for act={act!r}")


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, pad, act, block_oh):
        xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
        y = conv2d_tile(xp, w, b, stride=stride, act=act, block_oh=block_oh)
        ctx.save_for_backward(x, w, b, y if act != "linear" else None)
        ctx.conf = (stride, pad, act, block_oh)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, b, y = ctx.saved_tensors
        stride, pad, act, block_oh = ctx.conf
        if act != "linear":
            g = g * _act_grad_from_out(y, act)
        g = g.contiguous()
        # Unlike the JAX custom_vjp, which always computes all three
        # cotangents, a gradient nobody asked for is skipped - the image
        # input of the first layer, the zero bias of a bias-free layer.  The
        # gradients that are computed are unchanged.
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
        hp, wp = xp.shape[1], xp.shape[2]
        if need_x:
            dxp = conv2d_dgrad_tile(g, w, (hp, wp), stride=stride, block_oh=block_oh)
            dx = (dxp[:, pad:hp - pad, pad:wp - pad, :] if pad else dxp).to(x.dtype)
        if need_w:
            dw = conv2d_wgrad_tile(xp.contiguous(), g, w.shape[0], stride=stride,
                                   out_dtype=w.dtype)
        if need_b and b is not None:
            acc = torch.promote_types(g.dtype, torch.float32)   # fp64 stays fp64
            db = g.to(acc).sum(dim=(0, 1, 2)).to(b.dtype)
        return dx, dw, db, None, None, None, None


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    stride: int = 1,
    pad: int = 0,
    act: str = "linear",
    block_oh: int | None = None,
) -> torch.Tensor:
    return _Conv2d.apply(x, w, b, stride, pad, act, block_oh)
