"""SSD scan op for the models: the CUDA kernel (B5) forward, the plain
cross-chunk combine, and a plain backward.

As ``repro/kernels/ssd_chunk/ops.py``: ``ssd_scan`` is a drop-in for
``models.mamba2._ssd_chunk_scan``.  Its forward is the intra-chunk kernel
(its plain version on the CPU) followed by ``_combine``; its backward
recomputes through ``ssd_chunk_ref`` + ``_combine`` under autograd from the
saved (x, dt, A, B, C), as the reference's ``custom_vjp`` does through XLA -
there is no backward kernel to port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_chunk import kernel as _kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref


def _combine(y_intra, S, decay, pref, Cm, x_dtype):
    """Cross-chunk recurrence + inter-chunk output correction -> (y, final).

    The reference runs an associative scan over the chunks; with nc <= 16
    chunks a sequential loop, ``state_c = decay_c * state_{c-1} + S_c``, is
    the same recurrence (its sums round in another order).  The reference's
    ``initial_state`` argument is passed by no caller and is left out.
    """
    b, nc, h, n, p = S.shape
    t = y_intra.shape[1]
    q = t // nc
    g = Cm.shape[2]
    rep = h // g

    states = [S[:, 0]]
    for c in range(1, nc):
        states.append(decay[:, c, :, None, None] * states[-1] + S[:, c])
    S_in = torch.stack([torch.zeros_like(S[:, 0])] + states[:-1], dim=1)   # (B,nc,H,N,P)

    Ch = Cm.repeat_interleave(rep, dim=2) if g != h else Cm              # (B,T,H,N)
    Cc = Ch.reshape(b, nc, q, h, n).to(S.dtype)
    prefc = pref.reshape(b, nc, q, h)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", prefc[..., None] * Cc, S_in)
    y = y_intra.reshape(b, nc, q, h, p) + y_inter
    return y.reshape(b, t, h, p).to(x_dtype), states[-1]


def ssd_scan_ref(x, dt, A, Bm, Cm, chunk: int):
    """The plain scan: ``ssd_chunk_ref`` + ``_combine`` (the backward's path)."""
    return _combine(*ssd_chunk_ref(x, dt, A, Bm, Cm, chunk=chunk), Cm, x.dtype)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        out = _kernel.ssd_chunk_fwd(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(),
                                    chunk=chunk)
        return _combine(*out, Cm, x.dtype)

    @staticmethod
    def backward(ctx, gy, gfinal):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [u.detach().requires_grad_(need)
                   for u, need in zip(saved, ctx.needs_input_grad[:5])]
            y, final = ssd_scan_ref(*ins, ctx.chunk)
            outs = [(o, go) for o, go in ((y, gy), (final, gfinal)) if go is not None]
            wrt = [u for u in ins if u.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in outs], wrt, [go for _, go in outs],
                                           allow_unused=True)
                       if wrt and outs else ())
        return (*(next(got, None) if need else None for need in ctx.needs_input_grad[:5]), None)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 256):
    """(B,T,H,P) Mamba2 SSD scan -> (y in x's type, final_state (B,H,N,P) fp32)."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk)
