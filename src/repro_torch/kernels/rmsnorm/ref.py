"""Plain torch version of the fused RMSNorm kernel (== models.common.rms_norm).

fp32 statistics (fp64 stays fp64, for exact references), the normalised row
cast back to x's type, then multiplied by ``scale``; the result is in the
promoted type of x and scale, as in the reference.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.promote_types(dt, torch.float32))
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale
