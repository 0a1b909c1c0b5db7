"""Wrappers of the hand-written CUDA backward conv kernels: the input
gradient (dgrad, B2, ``csrc/conv2d_dgrad_tile.cu``) and the weight gradient
(wgrad, B3, ``csrc/conv2d_wgrad_tile.cu``).

The counterpart of ``repro/kernels/conv2d_tiled/backward.py``:
``rotate_filter``, ``conv2d_dgrad_tile`` and ``conv2d_wgrad_tile`` have its
signatures minus ``interpret``.  A CPU tensor takes the plain version
(``ref.py``), because there is no kernel to run there; a CUDA tensor
launches the kernel on the current stream or raises - there is no fallback.
Each wrapper's ``.launches`` counts its kernel launches (and nothing else),
so a run can show that its main path went through the kernel.

Both kernels are fp32 FFMA GEMMs whose tile and split-K are picked by a
rule of the shape alone (``dgrad_tile``/``dgrad_split``,
``wgrad_tile``/``wgrad_split``): the summation order, and so the result,
is the same on every run and every card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_tiled.ref import (
    conv2d_dgrad_ref,
    conv2d_wgrad_ref,
    rotate_filter_ref,
)

_DTYPES = (torch.float32, torch.bfloat16)
_SMS = 132               # SMs of an H100 SXM: the split-K rules' card

# The reference's name for the 180-degree-rotated, channel-swapped filter
# (``rotate_filter(w)[u, v, co, ci] == w[K-1-u, K-1-v, ci, co]``).  The
# dgrad kernel never builds it: it reads ``w`` rotated in place.
rotate_filter = rotate_filter_ref

# dgrad partial-kernel tiles: name -> (the C launcher's tile code, dx pixels
# per CTA, input channels per CTA, threads per CTA)
DGRAD_TILES = {
    "128x32": (0, 128, 32, 128),
    "128x64": (1, 128, 64, 256),
    "128x128": (2, 128, 128, 256),
}
DGRAD_BK = 16            # reduction terms (one tap, 16 output channels) per stage
# Split-K target of the dgrad kernel: at most 4 blocks of 256 threads per SM
# (one resident at a time: ptxas gives a 128 x 128 block's threads 254
# registers each for sm_90a),
# in threads so that the narrow tile gets proportionally more blocks; each
# slice at least _DGRAD_MIN_STAGES stages.  At most, not at least: with one
# block resident per SM, 3.9 waves of blocks take 4 wave times and 4.5 take
# 5, so rounding the split down keeps the last wave full.
_DGRAD_TARGET_THREADS = 4 * _SMS * 256
_DGRAD_MIN_STAGES = 8

# wgrad partial-kernel tiles: name -> (the C launcher's tile code, filter rows
# per CTA, output channels per CTA, threads per CTA)
WGRAD_TILES = {
    "32x32": (0, 32, 32, 64),
    "128x64": (1, 128, 64, 256),
    "128x128": (2, 128, 128, 256),
}
WGRAD_BK = 16            # pixels per wgrad stage (the kernel's BK)
# Split-K target of the wgrad kernel: about 4 blocks of 256 threads per SM
# of a 132-SM H100 (2 resident at a time), in threads so a smaller tile gets
# proportionally more blocks.  Constants, so the split - and the summation
# order - depends on the shape alone and a result is the same on every run
# and every card.
_WGRAD_TARGET_THREADS = 4 * _SMS * 256
_WGRAD_MIN_CHUNK = 64    # pixels per slice, at least (4 stages)

_ARGTYPES = {      # each launch function's C arguments before the stream
    "conv2d_dgrad_tile": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15,
    "conv2d_wgrad_tile": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_longlong]
    + [ctypes.c_int] * 4,
}


def dgrad_tile(cin: int) -> str:
    """The dgrad partial kernel's tile (dx pixels x input channels) for
    ``cin`` input channels: 128 x 128 (8 x 8 fp32 accumulators a thread)
    where Cin > 64, 128 x 64 where 32 < Cin <= 64, and the narrow 128 x 32
    otherwise, so that no CTA of YOLOv2-16's Cin = 32 layer carries idle
    columns."""
    if cin > 64:
        return "128x128"
    return "128x64" if cin > 32 else "128x32"


def dgrad_split(pixels: int, cin: int, kd: int) -> tuple[int, int]:
    """(splits, chunk) of the dgrad reduction over ``kd`` = K*K*Cout terms
    for a (``pixels`` = N*H*W) x ``cin`` output: as many slices as keep the
    blocks of ``dgrad_tile`` within ``_DGRAD_TARGET_THREADS`` threads, each
    slice at least ``_DGRAD_MIN_STAGES`` stages long, chunks a multiple of
    the stage.  Every slice is non-empty."""
    _, bm, bn, threads = DGRAD_TILES[dgrad_tile(cin)]
    tiles = -(-pixels // bm) * -(-cin // bn)
    stages = -(-kd // DGRAD_BK)
    target = _DGRAD_TARGET_THREADS // threads
    splits = max(1, min(target // tiles, stages // _DGRAD_MIN_STAGES))
    chunk = -(-stages // splits)
    return -(-stages // chunk), chunk * DGRAD_BK


def dgrad_gather(cout: int, stride: int) -> str:
    """The dgrad kernel's cotangent gather: "stride1" where the stride is 1
    and every stage's 16 reduction terms share one tap (Cout a multiple of
    ``DGRAD_BK``: every YOLOv2-16 conv), which walks the taps without
    division and loads 16-byte vectors; "general" otherwise (a division
    per stage, the stride's divisibility test per element)."""
    return "stride1" if stride == 1 and cout % DGRAD_BK == 0 else "general"


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
    _build.check_operands("conv2d_dgrad_tile", [g, w], _DTYPES, 4)
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
    pixels = n * h * wd
    if pixels == 0 or cin == 0:
        return out
    kd = k * k * cout
    if kd == 0 or oh == 0 or ow == 0:
        return out.zero_()
    code, _, bn, _ = DGRAD_TILES[dgrad_tile(cin)]
    splits, chunk = dgrad_split(pixels, cin, kd)
    if splits > _build.MAX_GRID_YZ or -(-cin // bn) > _build.MAX_GRID_YZ or pixels >= 2**31:
        raise ValueError(f"conv2d_dgrad_tile grid too large for N*H*W={pixels}, Cin={cin}")
    # split-K partials go to an fp32 workspace, summed in a fixed order by a
    # second kernel; one slice writes dx directly
    part = (torch.empty((splits, pixels, cin), dtype=torch.float32, device=g.device)
            if splits > 1 else None)
    _build.run("conv2d_dgrad_tile", _ARGTYPES["conv2d_dgrad_tile"], g.device,
               g.data_ptr(), w.data_ptr(), None if part is None else part.data_ptr(),
               out.data_ptr(), n, oh, ow, cout, k, cin, h, wd, stride, splits, chunk,
               int(dgrad_gather(cout, stride) == "stride1"),
               int(g.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), code)
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
    _build.check_operands("conv2d_wgrad_tile", [x, g], _DTYPES, 4)
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
    if splits > _build.MAX_GRID_YZ or -(-rows // bm) > _build.MAX_GRID_YZ:
        raise ValueError(f"conv2d_wgrad_tile grid too large for {rows} filter rows")
    part = torch.empty((splits, rows, cout), dtype=torch.float32, device=x.device)
    _build.run("conv2d_wgrad_tile", _ARGTYPES["conv2d_wgrad_tile"], x.device,
               x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(), n, h, wd, cin,
               kernel, cout, oh, ow, stride, splits, chunk,
               int(x.dtype == torch.bfloat16), int(g.dtype == torch.bfloat16),
               int(out_dtype == torch.bfloat16), code)
    conv2d_wgrad_tile.launches += 1
    return out


conv2d_wgrad_tile.launches = 0
