"""Plain torch version of the SSD intra-chunk kernel (``ssd_chunk_ref``).

The reference's ``repro/kernels/ssd_chunk/ref.py`` with one repair: the
intra-chunk decay is ``exp(where(tri, cum_i - cum_j, -inf))`` where the
reference writes ``where(tri, exp(cum_i - cum_j), 0)``.  The entries it keeps
are the same ``exp`` of the same values, so the forward is the reference's
bit for bit.  Above the diagonal ``cum_i - cum_j`` is positive and grows
with the chunk's total log-decay; past ~88.7 the reference's fp32 ``exp``
overflows there and the ``where``'s backward forms ``0 * inf = NaN`` in the
gradient of dt (and of A, and through them of everything upstream).  The
masked exponent never forms that ``inf`` (ROADMAP C.1).

Sums in fp32 (fp64 stays fp64, for exact references); every output fp32.
"""
from __future__ import annotations

import torch


def chunk_len(t: int, chunk: int) -> int:
    """Q = min(chunk, T); T must be a multiple of it (the reference asserts)."""
    q = min(chunk, t)
    if q < 1 or t % q:
        raise ValueError(f"sequence length {t} is not a multiple of the chunk {q}")
    return q


def causal_decay(cum: torch.Tensor) -> torch.Tensor:
    """(..., Q) inclusive log-decay prefix -> (..., Q, Q) ``exp(cum_i - cum_j)``
    for j <= i and 0 above the diagonal, with the exponent masked first."""
    q = cum.shape[-1]
    dseg = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=cum.device).tril()
    return torch.exp(torch.where(tri, dseg, float("-inf")))


def ssd_chunk_ref(x, dt, A, Bm, Cm, *, chunk: int = 256):
    """-> (y_intra (B,T,H,P), S (B,nc,H,N,P), decay (B,nc,H), pref (B,T,H))."""
    b, t, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    q = chunk_len(t, chunk)
    nc = t // q
    rep = h // g
    f = torch.float64 if torch.float64 in (x.dtype, dt.dtype, A.dtype, Bm.dtype, Cm.dtype) \
        else torch.float32

    xc = x.reshape(b, nc, q, h, p).to(f)
    dtc = dt.reshape(b, nc, q, h).to(f)
    Bc = Bm.reshape(b, nc, q, g, n).to(f)
    Cc = Cm.reshape(b, nc, q, g, n).to(f)
    Bh = Bc.repeat_interleave(rep, dim=3) if g != h else Bc
    Ch = Cc.repeat_interleave(rep, dim=3) if g != h else Cc

    dA = dtc * A.to(f)
    cum = torch.cumsum(dA, dim=2)                       # (B,nc,Q,H)
    ci = cum.permute(0, 1, 3, 2)                        # (B,nc,H,Q)
    cb = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    dt_j = dtc.permute(0, 1, 3, 2)                      # (B,nc,H,Q)
    m = cb * causal_decay(ci) * dt_j[..., None, :]
    y = torch.einsum("bchqk,bckhp->bcqhp", m, xc)

    tail = torch.exp(ci[..., -1:] - ci)
    w = tail * dt_j
    S = torch.einsum("bchq,bcqhn,bcqhp->bchnp", w, Bh, xc)
    decay = torch.exp(ci[..., -1])                      # (B,nc,H)
    pref = torch.exp(cum).reshape(b, t, h)
    return y.reshape(b, t, h, p), S, decay, pref
