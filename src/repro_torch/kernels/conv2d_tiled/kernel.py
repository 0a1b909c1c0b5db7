"""Wrapper of the hand-written CUDA forward conv kernel (``csrc/conv2d_tile.cu``).

``conv2d_tile`` (B1) has the signature of its counterpart in
``repro/kernels/conv2d_tiled/kernel.py`` minus ``interpret``: a CPU tensor
takes the plain version (``ref.py``), because there is no kernel to run
there; a CUDA tensor launches the kernel on the current stream or raises -
there is no fallback.  ``conv2d_tile.launches`` counts its kernel launches
(and nothing else), so a run can show that its main path went through the
kernel.  The backward kernels (B2, B3) live in ``backward.py``, as in the
reference, and are re-exported here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_tiled.backward import (  # noqa: F401 (re-exported)
    DGRAD_BK,
    DGRAD_TILES,
    WGRAD_BK,
    WGRAD_TILES,
    conv2d_dgrad_tile,
    conv2d_wgrad_tile,
    dgrad_split,
    dgrad_tile,
    rotate_filter,
    wgrad_split,
    wgrad_tile,
)
from repro_torch.kernels.conv2d_tiled.ref import conv2d_ref

_ACT_CODE = {"linear": 0, "relu": 1, "leaky": 2}
_DTYPES = (torch.float32, torch.bfloat16)
_BM = 64          # GEMM rows (and columns) per CTA of the forward kernel
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12


def conv2d_tile(
    x: torch.Tensor,                  # (N, H, W, Cin) halo-extended local tiles
    w: torch.Tensor,                  # (K, K, Cin, Cout)
    b: torch.Tensor | None = None,    # (Cout,)
    *,
    stride: int = 1,
    act: str = "linear",
    bc: int = 128,
    block_oh: int | None = None,
) -> torch.Tensor:
    """VALID conv + bias + fused activation; output dtype is
    ``promote_types(x.dtype, w.dtype)``.  ``bc`` and ``block_oh`` re-tile the
    TPU kernel's compute only; the CUDA kernel's tile is fixed, so both are
    validated and otherwise ignored."""
    if act not in _ACT_CODE:
        raise ValueError(f"unsupported fused activation {act!r}; one of {tuple(_ACT_CODE)}")
    if stride < 1 or bc < 1 or (block_oh is not None and block_oh < 1):
        raise ValueError(f"stride, bc and block_oh must be positive; got {stride}, {bc}, {block_oh}")
    if x.device.type == "cpu":
        return conv2d_ref(x, w, b, stride=stride, act=act)
    return _launch(x, w, b, stride, act)


conv2d_tile.launches = 0


def _launch(x, w, b, stride: int, act: str) -> torch.Tensor:
    _build.check_operands("conv2d_tile", [x, w], _DTYPES, 4)
    if b is not None and b.device != x.device:
        raise ValueError(f"bias on {b.device}, operands on {x.device}")
    n, h, wd, cin = x.shape
    k, k2, wcin, cout = w.shape
    if k != k2 or wcin != cin:
        raise ValueError(f"filter {tuple(w.shape)} does not match input {tuple(x.shape)}")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"bias shape {tuple(b.shape)} != ({cout},)")
    if h < k or wd < k:
        raise ValueError(f"input {h}x{wd} smaller than the {k}x{k} filter")
    oh = (h - k) // stride + 1
    ow = (wd - k) // stride + 1
    out = torch.empty((n, oh, ow, cout), dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    if n == 0 or cout == 0:
        return out
    if n > _build.MAX_GRID_YZ or -(-oh * ow // _BM) > _build.MAX_GRID_YZ:
        raise ValueError(f"conv2d_tile grid too large for N={n}, OH*OW={oh * ow}")
    bias = None if b is None else b.to(torch.float32).contiguous()
    _build.run("conv2d_tile", _ARGTYPES, x.device,
               x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
               out.data_ptr(), n, h, wd, cin, k, cout, oh, ow, stride, _ACT_CODE[act],
               int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16))
    conv2d_tile.launches += 1
    return out
