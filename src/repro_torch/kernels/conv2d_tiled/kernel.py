"""Wrapper of the hand-written CUDA forward conv kernel (``csrc/conv2d_tile.cu``).

``conv2d_tile`` (B1) has the signature of its counterpart in
``repro/kernels/conv2d_tiled/kernel.py`` minus ``interpret``: a CPU tensor
takes the plain version (``ref.py``), because there is no kernel to run
there; a CUDA tensor launches the kernel on the current stream or raises -
there is no fallback.  ``conv2d_tile.launches`` counts its kernel launches
(and nothing else), so a run can show that its main path went through the
kernel; ``conv2d_tile.launches_by_instance`` splits them by tile instance.
A launch issued while a CUDA graph is captured is counted once, at the
capture: the graph's replays run it again without Python, and the
captured serve step counts those (``serve/exec_cache.py:CapturedStep``,
fed by ``launch_counts``).
The kernel is an fp32 FFMA GEMM over the whole batch's output pixels whose
tile, split-K and gather are picked by rules of the shape alone
(``fwd_tile``, ``fwd_split``, ``fwd_gather``), so the summation order, and
the result, is the same on every run and every card.  The backward kernels
(B2, B3) live in ``backward.py``, as in the reference, and are re-exported
here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.conv2d_tiled.backward import (  # noqa: F401 (re-exported)
    _SMS,
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
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16

# forward partial-kernel tiles: name -> (the C launcher's tile code, output
# pixels per CTA, output channels per CTA, threads per CTA)
FWD_TILES = {
    "128x32": (0, 128, 32, 128),
    "128x64": (1, 128, 64, 256),
    "128x128": (2, 128, 128, 256),
}
FWD_BK = 16              # reduction terms (one tap, 16 input channels) per stage
# Split-K target of the forward kernel: one wave of two 256-thread blocks per
# SM of a 132-SM H100 (ptxas keeps a thread within 128 registers, so two
# blocks are resident), in threads so that the narrow tile gets
# proportionally more blocks; each slice at least _FWD_MIN_STAGES stages.
# Splits round down, so the last wave stays full, and a shape whose output
# tiles already fill half that wave is not split at all.
_FWD_TARGET_THREADS = 2 * _SMS * 256
_FWD_MIN_STAGES = 8


def fwd_tile(cout: int) -> str:
    """The forward partial kernel's tile (output pixels x output channels)
    for ``cout`` output channels: 128 x 128 (8 x 8 fp32 accumulators a
    thread) where Cout > 64, 128 x 64 where 32 < Cout <= 64, and the narrow
    128 x 32 otherwise, so that no CTA of YOLOv2-16's Cout = 32 first layer
    carries idle columns."""
    if cout > 64:
        return "128x128"
    return "128x64" if cout > 32 else "128x32"


def fwd_split(pixels: int, cout: int, kd: int) -> tuple[int, int]:
    """(splits, chunk) of the forward reduction over ``kd`` = K*K*Cin terms
    for a (``pixels`` = N*OH*OW) x ``cout`` output: as many slices as keep
    the blocks of ``fwd_tile`` within ``_FWD_TARGET_THREADS`` threads (one
    wave, rounded down), each slice at least ``_FWD_MIN_STAGES`` stages
    long, chunks a multiple of the stage.  Every slice is non-empty (an
    empty reduction, Cin = 0, is one slice of no stages)."""
    _, bm, bn, threads = FWD_TILES[fwd_tile(cout)]
    tiles = -(-pixels // bm) * -(-cout // bn)
    stages = -(-kd // FWD_BK)
    if stages == 0:
        return 1, FWD_BK
    target = _FWD_TARGET_THREADS // threads
    splits = max(1, min(target // tiles, stages // _FWD_MIN_STAGES))
    chunk = -(-stages // splits)
    return -(-stages // chunk), chunk * FWD_BK


def fwd_gather(cin: int) -> str:
    """The forward kernel's input gather: "vector" where every stage's 16
    reduction terms share one tap (Cin a multiple of ``FWD_BK``: every
    YOLOv2-16 conv but the Cin = 3 first layer), which walks the taps without
    division and loads 16-byte vectors at any stride (the forward reads x at
    S*oh + ki: the stride moves a row's base, not the walk); "general"
    otherwise (a division per term and stage, loads through registers)."""
    return "vector" if cin > 0 and cin % FWD_BK == 0 else "general"


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
    TPU kernel's compute only; the CUDA kernel's tile is picked by
    ``fwd_tile`` and spans the batch, so both are validated and otherwise
    ignored."""
    if act not in _ACT_CODE:
        raise ValueError(f"unsupported fused activation {act!r}; one of {tuple(_ACT_CODE)}")
    if stride < 1 or bc < 1 or (block_oh is not None and block_oh < 1):
        raise ValueError(f"stride, bc and block_oh must be positive; got {stride}, {bc}, {block_oh}")
    if x.device.type == "cpu":
        return conv2d_ref(x, w, b, stride=stride, act=act)
    return _launch(x, w, b, stride, act)


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
    pixels, kd = n * oh * ow, k * k * cin
    if x.numel() >= 2**31 or pixels * cout >= 2**31:
        raise ValueError(f"conv2d_tile takes fewer than 2**31 input and output elements; got "
                         f"x {tuple(x.shape)}, {pixels} x {cout} outputs")
    tile = fwd_tile(cout)
    code, _, bn, _ = FWD_TILES[tile]
    splits, chunk = fwd_split(pixels, cout, kd)
    if splits > _build.MAX_GRID_YZ or -(-cout // bn) > _build.MAX_GRID_YZ:
        raise ValueError(f"conv2d_tile grid too large for Cout={cout}, {splits} splits")
    bias = None if b is None else b.to(torch.float32).contiguous()
    # split-K partials go to an fp32 workspace, summed in a fixed order by a
    # second kernel that adds the bias and applies the activation
    part = (torch.empty((splits, pixels, cout), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    vec = fwd_gather(cin) == "vector" and x.data_ptr() % 16 == 0
    _build.run("conv2d_tile", _ARGTYPES, x.device,
               x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
               None if part is None else part.data_ptr(), out.data_ptr(),
               n, h, wd, cin, k, cout, oh, ow, stride, _ACT_CODE[act], splits, chunk, int(vec),
               int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), code)
    conv2d_tile.launches += 1
    conv2d_tile.launches_by_instance[tile] += 1
    return out


def reset_launches() -> None:
    """Sets every launch count of ``conv2d_tile`` to 0."""
    conv2d_tile.launches = 0
    conv2d_tile.launches_by_instance = dict.fromkeys(FWD_TILES, 0)


def launch_counts() -> dict[str, int]:
    """``conv2d_tile``'s launch counts as one flat dict: ``"conv2d_tile"``,
    and ``"conv2d_tile/<instance>"`` per tile instance."""
    return {"conv2d_tile": conv2d_tile.launches,
            **{f"conv2d_tile/{k}": v for k, v in conv2d_tile.launches_by_instance.items()}}


reset_launches()
