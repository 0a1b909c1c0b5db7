"""Wrapper of the hand-written CUDA conv kernel (``csrc/conv2d_tile.cu``).

``conv2d_tile`` has the signature of ``repro/kernels/conv2d_tiled/kernel.py:
conv2d_tile`` minus ``interpret``: a CPU tensor takes the plain version
(``ref.conv2d_ref``), because there is no kernel to run there; a CUDA tensor
launches the kernel on the current stream or raises - there is no fallback.
``conv2d_tile.launches`` counts kernel launches (and nothing else), so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_tiled.ref import conv2d_ref

_ACT_CODE = {"linear": 0, "relu": 1, "leaky": 2}
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
_BM = 64          # output pixels per CTA (the kernel's BM)


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv2d_tile")
    fn = lib.conv2d_tile_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.conv2d_tile_error_string.argtypes = [ctypes.c_int]
        lib.conv2d_tile_error_string.restype = ctypes.c_char_p
    return lib


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
    tensors = [x, w] + ([] if b is None else [b])
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            "conv2d_tile launches on CUDA tensors only (CPU tensors take the "
            f"plain version); got devices {[str(t.device) for t in tensors]}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"operands on different devices: {[str(t.device) for t in tensors]}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"x and w must be float32 or bfloat16; got {x.dtype}, {w.dtype}")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (N,H,W,Cin) and w (K,K,Cin,Cout); got {tuple(x.shape)}, {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    k, k2, wcin, cout = w.shape
    if k != k2 or wcin != cin:
        raise ValueError(f"filter {tuple(w.shape)} does not match input {tuple(x.shape)}")
    if b is not None and tuple(b.shape) != (cout,):
        raise ValueError(f"bias shape {tuple(b.shape)} != ({cout},)")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_tile needs contiguous NHWC input and HWIO filter")
    oh = (h - k) // stride + 1
    ow = (wd - k) // stride + 1
    if h < k or wd < k:
        raise ValueError(f"input {h}x{wd} smaller than the {k}x{k} filter")
    out = torch.empty((n, oh, ow, cout), dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    if n == 0 or cout == 0:
        return out
    if n > _MAX_GRID_YZ or -(-oh * ow // _BM) > _MAX_GRID_YZ:
        raise ValueError(f"conv2d_tile grid too large for N={n}, OH*OW={oh * ow}")
    bias = None if b is None else b.to(torch.float32).contiguous()
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv2d_tile_launch(
            x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), n, h, wd, cin, k, cout, oh, ow, stride, _ACT_CODE[act],
            int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), stream,
        )
    if err:
        raise RuntimeError(
            f"conv2d_tile launch failed: {lib.conv2d_tile_error_string(err).decode()}"
        )
    conv2d_tile.launches += 1
    return out
