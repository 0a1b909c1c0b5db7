"""Padded conv wrapper over the tiled conv kernel (``repro/.../ops.py:conv2d``).

``conv2d`` zero-pads the input and runs the VALID kernel - the same
decomposition the tiled executor uses, where the halo exchange delivers the
padding.  It is forward-only in this slice: the JAX reference routes the
backward pass through its own dgrad/wgrad kernels, whose CUDA ports are
later work, so ``backward`` raises instead of silently taking another path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.conv2d_tiled.kernel import conv2d_tile


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, stride, pad, act, block_oh):
        xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x
        return conv2d_tile(xp, w, b, stride=stride, act=act, block_oh=block_oh)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("dgrad/wgrad kernels: ROADMAP B2/B3")


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
