"""Compression for what crosses the wire - the port of
``repro/optim/compression.py``.

* The once-per-batch gradient reduction (``compress_with_feedback``):
  blockwise int8 quantisation of (grads + carried error); the residual is
  kept in a local fp32 error buffer and re-added next step (EF-SGD).
* The per-sample collectives' codec registry (``get_codec``: none | int8 |
  topk:<k>) and its pricing, ``WireCodec.wire_bytes`` and
  ``modeled_wire_bytes``, which the grouping cost model charges every comm
  term through.  The codecs' ``encode``/``decode`` and ``ef_encode`` belong
  to the codec executor, ROADMAP A.14, and raise until it lands.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.optim.optimizers import tree_unzip, tree_map


class CompressionState(NamedTuple):
    error: Any      # tree of fp32 residuals, mirroring grads


BLOCK = 256
# Smallest block the auto-shrink rule will go down to: thin halo strips
# (< BLOCK values) would otherwise degenerate to a single scale for the
# whole strip.
MIN_BLOCK = 32


def _pad_to_block(x: torch.Tensor, block: int = BLOCK):
    n = x.numel()
    pad = (-n) % block
    flat = x.reshape(-1)
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block), pad


def _auto_block(n: int, block: int) -> int:
    """Shrink the block (by halving, floor MIN_BLOCK) while a tensor fits in
    half of it - small strips get finer per-block scales."""
    while block > MIN_BLOCK and n <= block // 2:
        block //= 2
    return block


def int8_compress(g: torch.Tensor, block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q: int8 blocks, scale: fp32 per block)."""
    blocks, _ = _pad_to_block(g.to(torch.float32), block)
    scale = torch.amax(torch.abs(blocks), dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale[:, 0]


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def init_error(params) -> CompressionState:
    return CompressionState(
        tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    )


def compress_with_feedback(grads, state: CompressionState):
    """Quantise (grads + error); return (quantised-dequantised grads for the
    slow hop, new error).  The round trip is modelled here, so the EF
    invariant (sum of applied updates == sum of true grads up to fp32)
    holds and is testable."""

    def one(g, e):
        target = g.to(torch.float32) + e
        q, scale = int8_compress(target)
        deq = int8_decompress(q, scale, g.shape, torch.float32)
        return deq.to(g.dtype), target - deq

    newg, newe = tree_unzip(tree_map(one, grads, state.error), 2)
    return newg, CompressionState(newe)


# ---------------------------------------------------------------------------
# Wire codec registry: none | int8 | topk:<k>
# ---------------------------------------------------------------------------

_CODEC_EXECUTOR = "wire codec encode/decode: ROADMAP A.14 (wire codecs)"


@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One wire codec's spec and its modeled payload size.

    kind="int8": per-block int8 quantisation, block auto-shrunk for thin
    strips (see ``_auto_block``).  kind="topk": keep the k largest-|x|
    entries as (fp32 value, int32 index) pairs; k < 1 is a fraction of the
    element count, k >= 1 an absolute count (clamped to [1, n])."""

    spec: str
    kind: str            # "int8" | "topk"
    block: int = BLOCK   # int8 only
    k: float = 0.0       # topk only

    def _k_eff(self, n: int) -> int:
        k = self.k
        ke = int(round(k * n)) if k < 1.0 else int(round(k))
        return max(1, min(n, ke))

    def encode(self, x: torch.Tensor):
        raise NotImplementedError(_CODEC_EXECUTOR)

    def decode(self, payload, shape, dtype) -> torch.Tensor:
        raise NotImplementedError(_CODEC_EXECUTOR)

    def wire_bytes(self, n_elems: float, dtype_bytes: float) -> float:
        """Modeled payload bytes for an ``n_elems`` message.  int8 is modeled
        at exactly 1 byte/element: the per-block fp32 scales (4/BLOCK bytes
        per element) are amortised into the per-message latency + QDQ compute
        charges rather than the bandwidth term."""
        del dtype_bytes
        if self.kind == "int8":
            return float(n_elems)
        return self._k_eff(int(n_elems)) * 8.0   # fp32 value + int32 index


def get_codec(spec: str | None) -> WireCodec | None:
    """Parse a wire-codec spec: ``none`` (-> None), ``int8``, ``topk:<k>``.
    Raises ValueError on anything else, so plans fail at build time."""
    if spec is None or spec == "none":
        return None
    if spec == "int8":
        return WireCodec(spec="int8", kind="int8")
    if spec.startswith("topk:"):
        try:
            k = float(spec.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"bad topk spec {spec!r}: expected topk:<k>") from None
        if k <= 0:
            raise ValueError(f"topk k must be > 0, got {k}")
        return WireCodec(spec=spec, kind="topk", k=k)
    raise ValueError(f"unknown wire codec {spec!r}: expected none | int8 | topk:<k>")


def modeled_wire_bytes(n_elems: float, dtype_bytes: float, spec: str | None) -> float:
    """Planner helper: modeled bytes for an ``n_elems`` message under
    ``spec`` (``None``/"none" -> full precision)."""
    codec = get_codec(spec)
    if codec is None:
        return float(n_elems) * float(dtype_bytes)
    return codec.wire_bytes(n_elems, dtype_bytes)
