"""Mamba2 (SSD - state-space duality, arXiv:2405.21060): the full-sequence
block of ``repro/models/mamba2.py``.

Chunked SSD scan: within a chunk the sequence mixing is a masked (Q x Q)
quadratic form; across chunks a small state recurrence carries (B, H, N, P)
states.  ``mamba_block`` runs it through ``kernels.ssd_chunk.ops.ssd_scan``
(B5: the CUDA kernel on a card, its plain version on the CPU), as the
reference documents that op as a drop-in for ``_ssd_chunk_scan``.
``_ssd_chunk_scan`` is the plain version of the whole scan (``ssd_scan``'s
backward path); like the reference's it requires T % chunk == 0.  Both mask
the decay's exponent before ``exp`` (``kernels/ssd_chunk/ref.py``), so their
gradients stay finite where the reference's overflow (ROADMAP C.1).

Decode: ``mamba_decode`` is the O(1) step - the state is the cache
(``MambaState``: the fp32 SSM state, the conv ring and a per-slot length),
updated in place.

Not here yet: the sequence-sharded scan (``seq_axis``; ``parallel/``),
which raises naming ROADMAP A.18.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sequence import seq_halo_conv1d
from repro_torch.kernels.ssd_chunk.ops import ssd_scan, ssd_scan_ref
from repro_torch.models.common import dense_init, rms_norm


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    return s, d_in, nh


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """Params on ``gen.device``; A_log, D and dt_bias stay fp32 in any model."""
    s, d_in, nh = _dims(cfg)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    in_dim = 2 * d_in + 2 * s.n_groups * s.d_state + nh
    dev = gen.device
    w_in = dense_init(gen, (cfg.d_model, in_dim), dtype)
    conv_w = dense_init(gen, (s.d_conv, conv_dim), dtype, fan_in=s.d_conv)
    w_out = dense_init(gen, (d_in, cfg.d_model), dtype, fan_in=d_in)
    return {
        "w_in": w_in,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((nh,), dtype=torch.float32, device=dev),   # A = -exp(A_log)
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((d_in,), dtype=dtype, device=dev),
        "w_out": w_out,
    }


def _ssd_chunk_scan(
    x: torch.Tensor,      # (B, T, H, P)
    dt: torch.Tensor,     # (B, T, H) softplus'd step sizes, fp32
    A: torch.Tensor,      # (H,) negative, fp32
    Bm: torch.Tensor,     # (B, T, G, N)
    Cm: torch.Tensor,     # (B, T, G, N)
    chunk: int,
    seq_axis: Optional[str] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B,T,H,P) in x's type, final_state: (B,H,N,P)): the plain
    intra-chunk form and the cross-chunk recurrence of ``ssd_scan``, in fp32
    (fp64 stays fp64).  T must be a multiple of ``chunk``."""
    if seq_axis is not None:
        raise NotImplementedError("sequence-sharded SSD scan: ROADMAP A.18 (parallel/)")
    if x.shape[1] % chunk:
        raise ValueError(f"sequence length {x.shape[1]} is not a multiple of the chunk {chunk}")
    return ssd_scan_ref(x, dt, A, Bm, Cm, chunk)


class MambaState(NamedTuple):
    """Decode cache: SSM state (B, H, N, P) in fp32 (fp64 in an fp64 model),
    conv ring (B, K-1, conv_dim) in the activation type, and ``length``.
    The reference keeps one scalar length for the whole batch; here it is
    (B,) int32, one per slot, so that a slot is reset and viewed alone
    (``slot(i)``: a batch-1 view whose writes land in these tensors)."""

    ssm: torch.Tensor
    conv: torch.Tensor
    length: torch.Tensor

    @classmethod
    def init(cls, b, cfg: ModelConfig, dtype, device="cpu"):
        s, d_in, nh = _dims(cfg)
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        return cls(
            torch.zeros((b, nh, s.d_state, s.head_dim),
                        dtype=torch.promote_types(dtype, torch.float32), device=device),
            torch.zeros((b, s.d_conv - 1, conv_dim), dtype=dtype, device=device),
            torch.zeros((b,), dtype=torch.int32, device=device),
        )

    def slot(self, i: int) -> "MambaState":
        return MambaState(*(t[i:i + 1] for t in self))


def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    s, d_in, nh = _dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, nh], dim=-1)


def mamba_block(
    params: dict,
    u: torch.Tensor,
    cfg: ModelConfig,
    *,
    seq_axis: Optional[str] = None,
) -> torch.Tensor:
    """Full-sequence Mamba2 block.  u: (B, T, D) -> (B, T, D)."""
    if seq_axis is not None:
        raise NotImplementedError("sequence-sharded Mamba2 block: ROADMAP A.18 (parallel/)")
    s, d_in, nh = _dims(cfg)
    b, t, _ = u.shape
    proj = u @ params["w_in"]
    z, x, Bm, Cm, dt = _split_proj(proj, cfg)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    xbc = seq_halo_conv1d(xbc, params["conv_w"], params["conv_b"], None)
    xbc = F.silu(xbc)
    gn = s.n_groups * s.d_state
    x, Bm, Cm = torch.split(xbc, [d_in, gn, gn], dim=-1)
    x = x.reshape(b, t, nh, s.head_dim)
    Bm = Bm.reshape(b, t, s.n_groups, s.d_state)
    Cm = Cm.reshape(b, t, s.n_groups, s.d_state)
    dtf = F.softplus(dt.to(torch.promote_types(dt.dtype, torch.float32)) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, _ = ssd_scan(x, dtf, A, Bm, Cm, min(s.chunk, t))
    y = y + x * params["D"][:, None].to(x.dtype)
    y = y.reshape(b, t, d_in)
    y = rms_norm(y * F.silu(z), params["norm_scale"])
    return y @ params["w_out"]


def mamba_decode(
    params: dict,
    u: torch.Tensor,             # (B, 1, D)
    state: MambaState,
    cfg: ModelConfig,
) -> tuple[torch.Tensor, MambaState]:
    """O(1) single-token step, as the reference's.  Updates the state in
    place.  The one decay here, ``exp(dt * A)``, has a non-positive exponent
    (dt >= 0, A < 0), so it needs no mask: C.1's overflow comes from the
    chunked form's upper triangle, which the recurrence never forms."""
    s, d_in, nh = _dims(cfg)
    b = u.shape[0]
    acc = torch.promote_types(u.dtype, torch.float32)
    proj = (u @ params["w_in"])[:, 0]                   # (B, in_dim)
    z, x, Bm, Cm, dt = _split_proj(proj, cfg)
    xbc = torch.cat([x, Bm, Cm], dim=-1)                # (B, conv_dim)
    # a new tensor: the ring's shift below reads it, never the buffer it writes
    window = torch.cat([state.conv, xbc[:, None].to(state.conv.dtype)], dim=1)   # (B, K, conv_dim)
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"]) + params["conv_b"]
    conv_out = F.silu(conv_out)
    gn = s.n_groups * s.d_state
    x, Bm, Cm = torch.split(conv_out, [d_in, gn, gn], dim=-1)
    x = x.reshape(b, nh, s.head_dim)
    Bm = Bm.reshape(b, s.n_groups, s.d_state)
    Cm = Cm.reshape(b, s.n_groups, s.d_state)
    rep = nh // s.n_groups
    Bh = torch.repeat_interleave(Bm, rep, dim=1)        # (B, H, N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1)
    dtf = F.softplus(dt.to(acc) + params["dt_bias"])   # (B, H)
    A = -torch.exp(params["A_log"])
    a = torch.exp(dtf * A)                              # (B, H)
    upd = dtf[..., None, None] * Bh[..., :, None].to(acc) * x[..., None, :].to(acc)
    ssm = a[..., None, None] * state.ssm + upd          # (B, H, N, P)
    y = torch.einsum("bhn,bhnp->bhp", Ch.to(acc), ssm)
    y = y + x.to(acc) * params["D"][:, None]
    y = y.reshape(b, 1, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z[:, None]), params["norm_scale"])
    out = y @ params["w_out"]
    state.ssm.copy_(ssm)
    state.conv.copy_(window[:, 1:])
    state.length.add_(1)
    return out, state
