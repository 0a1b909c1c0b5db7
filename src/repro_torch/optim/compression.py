"""Compression for what crosses the wire - the port of
``repro/optim/compression.py``.

* The once-per-batch gradient reduction (``compress_with_feedback``):
  blockwise int8 quantisation of (grads + carried error); the residual is
  kept in a local fp32 error buffer and re-added next step (EF-SGD).
* The per-sample collectives (halo strips, the spatial->data reshard, the
  pipeline hand-off): the codec registry (``get_codec``: none | int8 |
  topk:<k>), each codec's ``encode``/``decode`` and its pricing
  (``WireCodec.wire_bytes``, ``modeled_wire_bytes``, which the grouping
  cost model charges every comm term through).  Forward strips are
  compressed stateless; the backward cotangents of recurring exchanges
  ride error feedback (``ef_encode``, DESIGN.md §12).

Codec contract (DESIGN.md §12): ``encode`` maps an array to a tuple of
payload tensors whose shapes depend only on the input shape; ``decode``
inverts it; a zero payload decodes to exact zeros, so a tile that receives
nothing sees SAME padding.  On the virtual tile mesh one tensor carries
every tile's block: ``tiles=k`` makes the leading k dimensions index the
senders, and each sender's block is encoded on its own, exactly as the
reference encodes one device's array - int8 blocks never span two tiles,
and top-k picks per tile.  One call serves all tiles.
"""
from __future__ import annotations

import dataclasses
import math
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


def _int8_rows(rows: torch.Tensor, block: int, *, reciprocal: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row of ``rows`` (T, n) quantised on its own: (q (T, nb, block)
    int8, scale (T, nb) fp32), the row zero-padded to whole blocks.
    ``reciprocal``: the scale as ``amax * fp32(1/127)``, the multiply XLA's
    compiled executors turn the reference's division by 127 into (an ulp
    off the division in some blocks)."""
    rows = rows.to(torch.float32)
    pad = (-rows.shape[1]) % block
    if pad:
        rows = F.pad(rows, (0, pad))
    blocks = rows.reshape(rows.shape[0], -1, block)
    amax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
    scale = amax * (1.0 / 127.0) if reciprocal else amax / 127.0
    q = torch.round(blocks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale[..., 0]


def int8_compress(g: torch.Tensor, block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (q: int8 blocks, scale: fp32 per block)."""
    q, scale = _int8_rows(g.reshape(1, -1), block)
    return q[0], scale[0]


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

@dataclasses.dataclass(frozen=True)
class WireCodec:
    """One wire codec.  ``encode``/``decode`` keep static payload shapes;
    ``wire_bytes`` is the modeled payload size for the cost model.

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

    def encode(self, x: torch.Tensor, tiles: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
        """Payload of ``x``, each block of its leading ``tiles`` dimensions
        encoded on its own: int8 -> (q (*lead, nb, block), scale (*lead,
        nb)) with the block auto-shrunk to one tile's element count; top-k
        -> (fp32 values, int32 indices into the tile's flattened block),
        both (*lead, k).  ``tiles=0`` is the reference's payload of one
        array."""
        lead = tuple(x.shape[:tiles])
        rows = x.reshape(math.prod(lead), -1)
        n = rows.shape[1]
        if self.kind == "int8":
            q, scale = _int8_rows(rows, _auto_block(n, self.block), reciprocal=True)
            return q.reshape(*lead, *q.shape[1:]), scale.reshape(*lead, -1)
        flat = rows.to(torch.float32)
        k = self._k_eff(n)
        idx = torch.topk(torch.abs(flat), k, dim=-1).indices
        vals = torch.gather(flat, -1, idx)
        return vals.reshape(*lead, k), idx.to(torch.int32).reshape(*lead, k)

    def decode(self, payload, shape, dtype, tiles: int = 0) -> torch.Tensor:
        """The array of ``shape`` (tile dimensions included) that
        ``payload`` carries; a zero payload decodes to exact zeros."""
        shape = tuple(shape)
        t = math.prod(shape[:tiles])
        n = math.prod(shape[tiles:])
        if self.kind == "int8":
            q, scale = payload
            flat = (q.to(torch.float32) * scale[..., None]).reshape(t, -1)
            return flat[:, :n].reshape(shape).to(dtype)
        vals, idx = payload
        out = vals.new_zeros((t, n), dtype=torch.float32).scatter(
            1, idx.reshape(t, -1).long(), vals.reshape(t, -1).to(torch.float32))
        return out.reshape(shape).to(dtype)

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


def ef_encode(codec: WireCodec, ct: torch.Tensor, res: torch.Tensor, tiles: int = 0):
    """One error-feedback step on a recurring exchange's cotangent: quantise
    (ct + res) per tile, return (payload for the wire, new residual).

    The residual telescopes: applied = decode(payload) satisfies
    ``sum_t applied_t == sum_t ct_t - res_final`` in fp32 - nothing is
    lost, only deferred (DESIGN.md §12)."""
    target = ct.to(torch.float32) + res
    payload = codec.encode(target, tiles)
    applied = codec.decode(payload, target.shape, torch.float32, tiles)
    return payload, target - applied
