"""SSD scan op for the models: the CUDA kernel (B5) forward, the plain
cross-chunk combine, and a plain backward.

As ``repro/kernels/ssd_chunk/ops.py``: ``ssd_scan`` is a drop-in for
``models.mamba2._ssd_chunk_scan``.  Its forward is the intra-chunk kernel
(its plain version on the CPU) followed by ``_combine``; its backward
recomputes through ``ssd_chunk_ref`` + ``_combine`` under autograd from the
saved (x, dt, A, B, C, initial state), as the reference's ``custom_vjp``
does through XLA - there is no backward kernel to port.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd_chunk import kernel as _kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref


def _combine(y_intra, S, decay, pref, Cm, x_dtype, initial_state=None, incoming=None):
    """Cross-chunk recurrence + inter-chunk output correction -> (y, final,
    total decay per sequence (B, H)).

    The reference runs an associative scan over the chunks; with nc <= 16
    chunks a sequential loop, ``state_c = decay_c * state_{c-1} + S_c`` and
    ``decay_c * ... * decay_0``, is the same recurrence (its sums round in
    another order).  ``initial_state`` (B, H, N, P) is the state entering
    each sequence; it is folded through each chunk's exclusive decay prefix
    into the chunk's incoming state, and into the final state through the
    total decay, as the reference's.  ``incoming`` maps the sequences'
    (total decay, final state) to the states entering them from earlier
    sequences (a sequence-sharded scan's cross-shard combine,
    ``models/mamba2.py``); it is added to ``initial_state``, as the
    reference adds its ``seq_scan_combine_hops``.
    """
    b, nc, h, n, p = S.shape
    t = y_intra.shape[1]
    q = t // nc
    g = Cm.shape[2]
    rep = h // g

    states, decays = [S[:, 0]], [decay[:, 0]]
    for c in range(1, nc):
        states.append(decay[:, c, :, None, None] * states[-1] + S[:, c])
        decays.append(decays[-1] * decay[:, c])
    S_in = torch.stack([torch.zeros_like(S[:, 0])] + states[:-1], dim=1)   # (B,nc,H,N,P)
    final, total = states[-1], decays[-1]
    if incoming is not None:
        inc = incoming(total, final)
        initial_state = inc if initial_state is None else inc + initial_state
    if initial_state is not None:
        excl = torch.stack([torch.ones_like(decay[:, 0])] + decays[:-1], dim=1)   # (B,nc,H)
        S_in = S_in + excl[..., None, None] * initial_state[:, None]
        final = final + total[..., None, None] * initial_state

    Ch = Cm.repeat_interleave(rep, dim=2) if g != h else Cm              # (B,T,H,N)
    Cc = Ch.reshape(b, nc, q, h, n).to(S.dtype)
    prefc = pref.reshape(b, nc, q, h)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", prefc[..., None] * Cc, S_in)
    y = y_intra.reshape(b, nc, q, h, p) + y_inter
    return y.reshape(b, t, h, p).to(x_dtype), final, total


def ssd_scan_ref(x, dt, A, Bm, Cm, chunk: int, initial_state=None, incoming=None):
    """The plain scan: ``ssd_chunk_ref`` + ``_combine`` (the backward's
    path) -> (y, final)."""
    y, final, _ = _combine(*ssd_chunk_ref(x, dt, A, Bm, Cm, chunk=chunk), Cm, x.dtype,
                           initial_state, incoming)
    return y, final


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk, initial_state, incoming):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, initial_state)
        ctx.chunk, ctx.incoming = chunk, incoming
        out = _kernel.ssd_chunk_fwd(x.contiguous(), dt, A, Bm.contiguous(), Cm.contiguous(),
                                    chunk=chunk)
        y, final, _ = _combine(*out, Cm, x.dtype, initial_state, incoming)
        return y, final

    @staticmethod
    def backward(ctx, gy, gfinal):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if u is None else u.detach().requires_grad_(need)
                   for u, need in zip(saved, ctx.needs_input_grad[:5] + ctx.needs_input_grad[6:7])]
            y, final = ssd_scan_ref(*ins[:5], ctx.chunk, ins[5], ctx.incoming)
            outs = [(o, go) for o, go in ((y, gy), (final, gfinal)) if go is not None]
            wrt = [u for u in ins if u is not None and u.requires_grad]
            got = iter(torch.autograd.grad([o for o, _ in outs], wrt, [go for _, go in outs],
                                           allow_unused=True)
                       if wrt and outs else ())
        grads = [next(got, None) if u is not None and u.requires_grad else None for u in ins]
        return (*grads[:5], None, grads[5], None)


def ssd_scan(x, dt, A, Bm, Cm, chunk: int = 256, initial_state=None, incoming=None):
    """(B,T,H,P) Mamba2 SSD scan -> (y in x's type, final_state (B,H,N,P)
    fp32), from ``initial_state`` (B,H,N,P) (zeros when ``None``) plus what
    ``incoming`` hands each sequence (``_combine``).  One kernel launch; the
    backward recomputes through ``ssd_scan_ref`` - ``incoming`` included,
    so the gradient of a sequence's incoming state reaches the final states
    and decays of the sequences before it - and returns the gradient of
    ``initial_state`` too."""
    return _SSDScan.apply(x, dt, A, Bm, Cm, chunk, initial_state, incoming)
