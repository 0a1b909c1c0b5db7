"""Wrappers of the hand-written CUDA conv kernels (``csrc/*.cu``).

``conv2d_tile`` (forward, B1), ``conv2d_dgrad_tile`` (input gradient, B2)
and ``conv2d_wgrad_tile`` (weight gradient, B3) have the signatures of their
counterparts in ``repro/kernels/conv2d_tiled/kernel.py`` and ``backward.py``
minus ``interpret``: a CPU tensor takes the plain version (``ref.py``),
because there is no kernel to run there; a CUDA tensor launches the kernel
on the current stream or raises - there is no fallback.  Each wrapper's
``.launches`` counts its kernel launches (and nothing else), so a run can
show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_tiled.ref import conv2d_dgrad_ref, conv2d_ref, conv2d_wgrad_ref

_ACT_CODE = {"linear": 0, "relu": 1, "leaky": 2}
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_YZ = 65535
_BM = 64          # GEMM rows (and columns) per CTA of the forward and dgrad kernels

# wgrad partial-kernel tiles: name -> (the C launcher's tile code, filter rows
# per CTA, output channels per CTA, threads per CTA)
WGRAD_TILES = {
    "32x32": (0, 32, 32, 64),
    "128x64": (1, 128, 64, 256),
    "128x128": (2, 128, 128, 256),
}
WGRAD_BK = 16            # pixels per wgrad stage (the kernel's BK)
# Split-K target of the wgrad kernel: about 4 blocks of 256 threads per SM of
# a 132-SM H100 (2 resident at a time), in threads so a smaller tile gets
# proportionally more blocks.  Constants, so the split - and the summation
# order - depends on the shape alone and a result is the same on every run
# and every card.
_WGRAD_TARGET_THREADS = 4 * 132 * 256
_WGRAD_MIN_CHUNK = 64    # pixels per slice, at least (4 stages)

_ARGTYPES = {      # each launch function's C arguments before the stream
    "conv2d_tile": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12,
    "conv2d_dgrad_tile": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11,
    "conv2d_wgrad_tile": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_longlong]
    + [ctypes.c_int] * 4,
}


def _check_cuda(name: str, tensors) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError(
            f"{name} launches on CUDA tensors only (CPU tensors take the "
            f"plain version); got devices {[str(t.device) for t in tensors]}"
        )
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"operands on different devices: {[str(t.device) for t in tensors]}")
    if any(t.dtype not in _DTYPES for t in tensors):
        raise TypeError(f"{name} takes float32 or bfloat16 operands; got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.dim() != 4 for t in tensors):
        raise ValueError(f"{name} takes 4-d operands; got {[tuple(t.shape) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous NHWC / HWIO operands")


def _run(name: str, device: torch.device, *args) -> None:
    _build.run(name, _ARGTYPES[name], device, *args)


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
    _check_cuda("conv2d_tile", [x, w])
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
    if n > _MAX_GRID_YZ or -(-oh * ow // _BM) > _MAX_GRID_YZ:
        raise ValueError(f"conv2d_tile grid too large for N={n}, OH*OW={oh * ow}")
    bias = None if b is None else b.to(torch.float32).contiguous()
    _run("conv2d_tile", x.device,
         x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
         out.data_ptr(), n, h, wd, cin, k, cout, oh, ow, stride, _ACT_CODE[act],
         int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16))
    conv2d_tile.launches += 1
    return out


def conv2d_dgrad_tile(
    g: torch.Tensor,                  # (N, OH, OW, Cout) cotangent of the VALID conv
    w: torch.Tensor,                  # (K, K, Cin, Cout) forward HWIO filter
    in_hw: tuple[int, int],           # (H, W) of the forward (padded) input
    *,
    stride: int = 1,
    block_oh: int | None = None,
) -> torch.Tensor:
    """Input gradient of ``conv2d_tile(x, w, stride=stride)``: (N, H, W, Cin)
    in ``promote_types(g.dtype, w.dtype)``.  Rows and columns past the last
    forward window get exact zeros.  ``block_oh`` re-tiles the TPU kernel's
    compute only and is validated and otherwise ignored."""
    if stride < 1 or (block_oh is not None and block_oh < 1):
        raise ValueError(f"stride and block_oh must be positive; got {stride}, {block_oh}")
    if g.device.type == "cpu":
        return conv2d_dgrad_ref(g, w, in_hw, stride)
    _check_cuda("conv2d_dgrad_tile", [g, w])
    n, oh, ow, cout = g.shape
    k, k2, cin, wcout = w.shape
    h, wd = in_hw
    if k != k2 or wcout != cout:
        raise ValueError(f"filter {tuple(w.shape)} does not match cotangent {tuple(g.shape)}")
    if h - ((oh - 1) * stride + k) < 0 or wd - ((ow - 1) * stride + k) < 0:
        raise ValueError(
            f"cotangent {tuple(g.shape)} inconsistent with input {tuple(in_hw)}, K={k}, S={stride}"
        )
    out = torch.empty((n, h, wd, cin), dtype=torch.promote_types(g.dtype, w.dtype),
                      device=g.device)
    if n == 0 or cin == 0:
        return out
    if n > _MAX_GRID_YZ or -(-h * wd // _BM) > _MAX_GRID_YZ:
        raise ValueError(f"conv2d_dgrad_tile grid too large for N={n}, H*W={h * wd}")
    _run("conv2d_dgrad_tile", g.device,
         g.data_ptr(), w.data_ptr(), out.data_ptr(), n, oh, ow, cout, k, cin, h, wd,
         stride, int(g.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16))
    conv2d_dgrad_tile.launches += 1
    return out


conv2d_dgrad_tile.launches = 0


def wgrad_tile(rows: int, cout: int) -> str:
    """The wgrad partial kernel's tile for a (rows = K*K*Cin) x Cout output:
    32 x 32 for outputs that small (the first layer's 27 x 32), 128 x 128
    where Cout > 64, else 128 x 64."""
    if rows <= 32 and cout <= 32:
        return "32x32"
    return "128x128" if cout > 64 else "128x64"


def wgrad_split(pixels: int, rows: int, cout: int) -> tuple[int, int]:
    """(splits, chunk) of the wgrad reduction over ``pixels`` = N*OH*OW for
    a (rows = K*K*Cin) x Cout output: enough slices to put about
    ``_WGRAD_TARGET_THREADS`` threads in flight in ``wgrad_tile``'s blocks,
    each slice at least ``_WGRAD_MIN_CHUNK`` pixels long, chunks a multiple
    of the stage."""
    _, bm, bn, threads = WGRAD_TILES[wgrad_tile(rows, cout)]
    tiles = -(-rows // bm) * -(-cout // bn)
    target = _WGRAD_TARGET_THREADS // threads
    splits = max(1, min(-(-target // tiles), -(-pixels // _WGRAD_MIN_CHUNK)))
    chunk = -(-pixels // splits)
    chunk = -(-chunk // WGRAD_BK) * WGRAD_BK
    return -(-pixels // chunk), chunk


def conv2d_wgrad_tile(
    x: torch.Tensor,                  # (N, H, W, Cin) forward (padded) input
    g: torch.Tensor,                  # (N, OH, OW, Cout) cotangent of the VALID conv
    kernel: int,
    *,
    stride: int = 1,
    bc: int = 128,
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Weight gradient (K, K, Cin, Cout), summed over every tile and image
    of the batch, in ``out_dtype`` (default: the promoted x/g dtype).
    ``bc`` re-tiles the TPU kernel's compute only and is validated and
    otherwise ignored."""
    if stride < 1 or bc < 1 or kernel < 1:
        raise ValueError(f"kernel, stride and bc must be positive; got {kernel}, {stride}, {bc}")
    if out_dtype is None:
        out_dtype = torch.promote_types(x.dtype, g.dtype)
    if x.device.type == "cpu":
        return conv2d_wgrad_ref(x, g, kernel, stride, out_dtype)
    _check_cuda("conv2d_wgrad_tile", [x, g])
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16; got {out_dtype}")
    n, h, wd, cin = x.shape
    gn, oh, ow, cout = g.shape
    if gn != n or (h - kernel) // stride + 1 != oh or (wd - kernel) // stride + 1 != ow:
        raise ValueError(
            f"cotangent {tuple(g.shape)} does not match input {tuple(x.shape)}, "
            f"K={kernel}, S={stride}"
        )
    rows = kernel * kernel * cin
    out = torch.empty((kernel, kernel, cin, cout), dtype=out_dtype, device=x.device)
    pixels = n * oh * ow
    if pixels == 0 or cout == 0 or cin == 0:
        return out.zero_()
    code, bm, _, _ = WGRAD_TILES[wgrad_tile(rows, cout)]
    splits, chunk = wgrad_split(pixels, rows, cout)
    if splits > _MAX_GRID_YZ or -(-rows // bm) > _MAX_GRID_YZ:
        raise ValueError(f"conv2d_wgrad_tile grid too large for {rows} filter rows")
    part = torch.empty((splits, rows, cout), dtype=torch.float32, device=x.device)
    _run("conv2d_wgrad_tile", x.device,
         x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(), n, h, wd, cin,
         kernel, cout, oh, ow, stride, splits, chunk,
         int(x.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16),
         int(out_dtype == torch.bfloat16), code)
    conv2d_wgrad_tile.launches += 1
    return out


conv2d_wgrad_tile.launches = 0
