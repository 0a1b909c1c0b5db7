"""Wrapper of the hand-written CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

``rmsnorm(x, scale, eps=1e-6, block_rows=256)`` has the signature of
``repro/kernels/rmsnorm/kernel.py:rmsnorm`` minus ``interpret``.  A CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel on the current stream or raises - there is no fallback.  The output
is in the promoted type of x and scale (the reference kernel's x type when
the two agree, as they do in every model).  ``rmsnorm.launches`` counts the
kernel's launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2
_MAX_ROWS = 2**31 - 1


def rmsnorm(
    x: torch.Tensor,              # (..., D)
    scale: torch.Tensor,          # (D,)
    *,
    eps: float = 1e-6,
    block_rows: int = 256,
) -> torch.Tensor:
    """RMSNorm over the last dim.  ``block_rows`` re-tiles the TPU kernel's
    rows only; the CUDA kernel takes one row per block, so it is validated
    and otherwise ignored."""
    if block_rows < 1:
        raise ValueError(f"block_rows must be positive; got {block_rows}")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"rmsnorm launches on CUDA tensors on one device; got "
                         f"{x.device} and {scale.device}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm takes float32 or bfloat16; got {x.dtype}, {scale.dtype}")
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if not x.is_contiguous():
        raise ValueError("rmsnorm needs a contiguous x")
    rows = x.numel() // d if d else 0
    out = torch.empty(x.shape, dtype=torch.promote_types(x.dtype, scale.dtype), device=x.device)
    if rows == 0 or d == 0:
        return out
    if rows > _MAX_ROWS:
        raise ValueError(f"rmsnorm grid too large for {rows} rows")
    s = scale.contiguous()
    _build.run("rmsnorm", _ARGTYPES, x.device, x.data_ptr(), s.data_ptr(), out.data_ptr(),
               rows, d, float(eps), int(x.dtype == torch.bfloat16),
               int(s.dtype == torch.bfloat16))
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
