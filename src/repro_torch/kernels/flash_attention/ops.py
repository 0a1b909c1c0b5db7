"""Flash-attention op for the models: the CUDA kernel (B4) forward and the
plain blocked-streaming backward.

As ``repro/kernels/flash_attention/ops.py``: a drop-in for
``models.attention._sdpa`` on the training path (default positions, no
cache).  The forward is the kernel (its plain version on the CPU); the
backward recomputes through ``models.attention._sdpa_blocked`` with
``q_chunk=bq``, ``kv_chunk=bk`` and arange positions under autograd, as the
reference's ``custom_vjp`` does - there is no backward kernel to port.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import kernel as _kernel


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, bq, bk):
        ctx.save_for_backward(q, k, v)
        ctx.conf = (causal, window, scale, bq, bk)
        return _kernel.flash_attention_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal, window=window,
            scale=scale, bq=bq, bk=bk)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.attention import _sdpa_blocked

        q, k, v = ctx.saved_tensors
        causal, window, scale, bq, bk = ctx.conf
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
            tq, tk = q.shape[1], k.shape[1]
            out = _sdpa_blocked(
                *qkv, torch.arange(tq, device=q.device), torch.arange(tk, device=q.device),
                causal=causal, window=window, scale=scale, q_chunk=bq, kv_chunk=bk)
            dq, dk, dv = torch.autograd.grad(out, qkv, g)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    bq: int = 512,
    bk: int = 512,
) -> torch.Tensor:
    return _FlashAttention.apply(q, k, v, causal, window, scale, bq, bk)
