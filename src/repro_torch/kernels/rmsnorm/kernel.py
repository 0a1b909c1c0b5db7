"""Wrapper of the hand-written CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

``rmsnorm(x, scale, eps=1e-6, block_rows=256)`` has the signature of
``repro/kernels/rmsnorm/kernel.py:rmsnorm`` minus ``interpret``.  A CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
kernel on the current stream or raises - there is no fallback.  The output
is in the promoted type of x and scale (the reference kernel's x type when
the two agree, as they do in every model).  Which of the kernel's instances
runs is fixed by the types, the width and the bases' alignment alone
(``rms_instance``).  ``rmsnorm.launches`` counts the kernel's launches and
nothing else; ``rmsnorm.launches_by_instance`` splits them by instance.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 3
_MAX_ROWS = 2**31 - 1
_VEC_BYTES = 16          # one vector access
# A warp keeps a row in registers while the row's x and scale vectors take
# at most this many bytes a lane (128 registers); wider rows read x twice.
_REGS_BYTES_PER_LANE = 512
# instance name -> the C launcher's instance code
INSTANCES = {
    "warp_scalar": 0,        # element accesses, x read twice: any width, any alignment
    "warp_stream": 1,        # 16-byte accesses, x read twice: rows wider than the registers
    "warp_regs4": 2,         # 16-byte accesses, the row in registers: <= 4 vectors a lane
    "warp_regs8": 3,         # ... <= 8 vectors a lane
    "warp_regs16": 4,        # ... <= 16 vectors a lane
}


def rms_instance(x_dtype: torch.dtype, scale_dtype: torch.dtype, d: int,
                 aligned: bool = True) -> str:
    """The kernel instance that normalises rows of ``d`` elements of
    ``x_dtype`` with a ``scale_dtype`` scale, where ``aligned`` says whether
    x's and scale's bases are 16-byte aligned: a pure function of the four,
    never chosen by a failure.  A width that is a multiple of the 16-byte
    vector on aligned bases takes the vector path: the smallest ``regs``
    instance that holds the row and its scale in registers, else the
    ``stream`` instance; any other takes the scalar instance."""
    vec = _VEC_BYTES // x_dtype.itemsize
    if d % vec or not aligned:
        return "warp_scalar"
    per_lane = -(-d // vec // 32)
    bytes_per_vec = _VEC_BYTES + vec * scale_dtype.itemsize     # x and its scale
    for nv in (4, 8, 16):
        if per_lane <= nv and nv * bytes_per_vec <= _REGS_BYTES_PER_LANE:
            return f"warp_regs{nv}"
    return "warp_stream"


def rmsnorm(
    x: torch.Tensor,              # (..., D)
    scale: torch.Tensor,          # (D,)
    *,
    eps: float = 1e-6,
    block_rows: int = 256,
) -> torch.Tensor:
    """RMSNorm over the last dim.  ``block_rows`` re-tiles the TPU kernel's
    rows only; the CUDA kernel takes one row per warp, so it is validated
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
    aligned = x.data_ptr() % _VEC_BYTES == 0 and s.data_ptr() % _VEC_BYTES == 0
    instance = rms_instance(x.dtype, s.dtype, d, aligned)
    _build.run("rmsnorm", _ARGTYPES, x.device, x.data_ptr(), s.data_ptr(), out.data_ptr(),
               rows, d, float(eps), int(x.dtype == torch.bfloat16),
               int(s.dtype == torch.bfloat16), INSTANCES[instance])
    rmsnorm.launches += 1
    rmsnorm.launches_by_instance[instance] += 1
    return out


def reset_launches() -> None:
    """Sets every launch count of the wrapper to 0."""
    rmsnorm.launches = 0
    rmsnorm.launches_by_instance = dict.fromkeys(INSTANCES, 0)


reset_launches()
