"""Plain torch version of the tiled conv2d kernel (VALID conv + bias + act).

The counterpart of ``repro/kernels/conv2d_tiled/ref.py``: fp32 operands,
NHWC/HWIO at the interface, output cast to the promoted dtype.  CPU tensors
take this path inside ``conv2d_tile``; on the card it is only the yardstick
the kernel is held against (set ``torch.backends.cudnn.allow_tf32 = False``
first, or cuDNN computes the fp32 conv in TF32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_ref(
    x: torch.Tensor,                  # (N, H, W, Cin)
    w: torch.Tensor,                  # (K, K, Cin, Cout)
    b: torch.Tensor | None = None,    # (Cout,)
    *,
    stride: int = 1,
    act: str = "linear",
) -> torch.Tensor:
    y = F.conv2d(
        x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1), stride=stride
    ).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.float()
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    elif act == "leaky":
        y = torch.where(y > 0, y, 0.1 * y)
    elif act != "linear":
        raise ValueError(f"unsupported fused activation {act!r}")
    return y.to(torch.promote_types(x.dtype, w.dtype)).contiguous()
