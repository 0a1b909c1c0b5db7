"""Sequence-dimension operators of the LM mixers (``repro/core/sequence.py``).

Only the unsharded causal conv is here: ``seq_halo_conv1d`` with
``axis=None``, Mamba2's depthwise conv before the SSM.  Its sharded form
(the K-1 token left halo from the previous shard) and the reference's
``seq_scan_combine``, ``seq_scan_combine_hops``, ``swa_kv_halo`` and
``swa_position_ids`` belong to sequence-sharded paths, which come with
``parallel/`` (ROADMAP A.18).
"""
from __future__ import annotations

import torch


def seq_halo_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    axis: str | None,
    *,
    seq_dim: int = 1,
) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, T, D); w: (K, D) depthwise taps;
    output same shape as x.  The first K-1 positions see zeros (causal
    padding).  As the reference: a sum of K shifted slices, each product
    and sum in x's type."""
    if axis is not None:
        raise NotImplementedError("sequence-sharded causal conv (a halo from the previous "
                                  "shard): ROADMAP A.18 (parallel/)")
    k = w.shape[0]
    t = x.shape[seq_dim]
    pad_shape = list(x.shape)
    pad_shape[seq_dim] = k - 1
    xh = torch.cat([x.new_zeros(pad_shape), x], dim=seq_dim)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xh.narrow(seq_dim, i, t) * w[i]
    if b is not None:
        out = out + b
    return out
