"""Plain torch version of the flash-attention kernel (``attention_ref``).

The whole (Tq, Tk) logits tile in fp32 (fp64 stays fp64), masked with the
finite -1e30, softmax, weighted sum, output in q's type.  ``scaled_q`` is
the reference's ``(q * scale).astype(f32)``: JAX multiplies a bf16 array by a
Python float in bf16, so the scale is rounded to q's type first and the
product is rounded to it too.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def rounded_scale(scale: float, dtype: torch.dtype) -> float:
    """``scale`` rounded to ``dtype``, as a Python float (no device copy)."""
    return float(torch.tensor(scale, dtype=dtype))


def scaled_q(q: torch.Tensor, scale: float) -> torch.Tensor:
    # q * (a float exact in q's type) rounds the product to q's type, as JAX does
    return (q * rounded_scale(scale, q.dtype)).to(torch.promote_types(q.dtype, torch.float32))


def attention_ref(
    q: torch.Tensor,              # (B, Tq, Hq, Dh)
    k: torch.Tensor,              # (B, Tk, Hkv, Dh)
    v: torch.Tensor,              # (B, Tk, Hkv, Dh)
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    b, tq, hq, dh = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else dh ** -0.5
    qf = scaled_q(q, scale)
    acc = qf.dtype
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qf.reshape(b, tq, hkv, rep, dh), k.to(acc))
    q_pos = torch.arange(tq, device=q.device)
    k_pos = torch.arange(tk, device=q.device)
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs, v.to(acc))
    return out.reshape(b, tq, hq, dh).to(q.dtype)
