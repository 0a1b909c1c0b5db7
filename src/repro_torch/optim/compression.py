"""Int8 gradient compression with error feedback for the once-per-batch
gradient reduction - the trainer's part of ``repro/optim/compression.py``.

Blockwise int8 quantisation of (grads + carried error); the residual is
kept in a local fp32 error buffer and re-added next step (EF-SGD).  The wire
codecs of the per-sample collectives (``WireCodec``, top-k, ``ef_encode``)
are ROADMAP A.14.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.optim.optimizers import tree_unzip, tree_map


class CompressionState(NamedTuple):
    error: Any      # tree of fp32 residuals, mirroring grads


BLOCK = 256


def _pad_to_block(x: torch.Tensor, block: int = BLOCK):
    n = x.numel()
    pad = (-n) % block
    flat = x.reshape(-1)
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, block), pad


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
