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

Sequence parallelism (``seq_axis``, an axis of the active virtual mesh,
``parallel/api.py``): the (B, T) sequences split into S contiguous shards
of T/S tokens.  The conv takes each shard's K-1 token left halo from the
previous shard (``core/sequence.py:seq_halo_conv1d`` over a free
(B, S, T/S, .) view), one scan runs every shard as a sequence of its own -
(B*S, T/S, H, P), one B5 launch - and the shards' (total decay, final
state) summaries go through ``seq_scan_combine_hops``; what each shard
receives is folded into it as its initial state, as the reference folds
its cross-shard handoff (``_combine``).

Decode: ``mamba_decode`` is the O(1) step - the state is the cache
(``MambaState``: the fp32 SSM state, the conv ring and a per-slot length),
updated in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sequence import seq_halo_conv1d, seq_scan_combine_hops
from repro_torch.kernels.ssd_chunk.ops import ssd_scan, ssd_scan_ref
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.parallel.api import axis_size, captured_ctx


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


def _cross_shard(seq_axis: str, b: int, n: int):
    """``_combine``'s ``incoming`` for B sequences of n shards each, laid
    out (B*n, ...): ``seq_scan_combine_hops`` over the shard dimension,
    under the mesh active now (a backward may run on another thread)."""
    enter = captured_ctx()

    def incoming(total, final):
        with enter():
            inc = seq_scan_combine_hops(total.reshape(b, n, *total.shape[1:]),
                                        final.reshape(b, n, *final.shape[1:]),
                                        seq_axis, shard_dim=1)
        return inc.reshape(final.shape)

    return incoming


def _sharded_scan(scan, x, dt, A, Bm, Cm, chunk: int, seq_axis: str, initial_state=None):
    """``scan`` (``ssd_scan`` or ``ssd_scan_ref``) over the shards of the
    (B, T, ...) sequences along mesh axis ``seq_axis``: each (B, T) row
    viewed as (B*S, T/S), one scan over all shards with the cross-shard
    combine -> (y (B, T, H, P), each shard's final state (B, S, H, N, P)).
    ``initial_state`` (B, S, H, N, P), when given, is added to what each
    shard receives, as the reference adds its shard-local one."""
    b, t = x.shape[:2]
    n = axis_size(seq_axis)
    if t % n:
        raise ValueError(f"sequence length {t} does not split into the {n} shards of "
                         f"axis {seq_axis!r}")

    def shards(u):
        return u.reshape(b * n, t // n, *u.shape[2:])

    init = None if initial_state is None else initial_state.reshape(b * n,
                                                                   *initial_state.shape[2:])
    y, final = scan(shards(x), shards(dt), A, shards(Bm), shards(Cm), chunk, init,
                    _cross_shard(seq_axis, b, n))
    return y.reshape(x.shape), final.reshape(b, n, *final.shape[1:])


def _ssd_chunk_scan(
    x: torch.Tensor,      # (B, T, H, P)
    dt: torch.Tensor,     # (B, T, H) softplus'd step sizes, fp32
    A: torch.Tensor,      # (H,) negative, fp32
    Bm: torch.Tensor,     # (B, T, G, N)
    Cm: torch.Tensor,     # (B, T, G, N)
    chunk: int,
    seq_axis: Optional[str] = None,
    initial_state: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y: (B,T,H,P) in x's type, final_state: (B,H,N,P)): the plain
    intra-chunk form and the cross-chunk recurrence of ``ssd_scan``, in fp32
    (fp64 stays fp64), from ``initial_state`` (zeros when ``None``).  Under
    ``seq_axis`` the T tokens are S shards of T/S (``_sharded_scan``):
    ``initial_state`` and the final states are per shard, (B, S, H, N, P).
    Each scanned length must be a multiple of ``chunk``."""
    t = x.shape[1] // (1 if seq_axis is None else axis_size(seq_axis))
    if t % chunk:
        raise ValueError(f"sequence length {t} is not a multiple of the chunk {chunk}")
    if seq_axis is None:
        return ssd_scan_ref(x, dt, A, Bm, Cm, chunk, initial_state)
    return _sharded_scan(ssd_scan_ref, x, dt, A, Bm, Cm, chunk, seq_axis, initial_state)


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
    """Full-sequence Mamba2 block.  u: (B, T, D) -> (B, T, D).  Under
    ``seq_axis`` the sequences run as S shards of T/S tokens (module
    docstring), the scan at ``min(chunk, T/S)``."""
    s, d_in, nh = _dims(cfg)
    b, t, _ = u.shape
    n = 1 if seq_axis is None else axis_size(seq_axis)
    proj = u @ params["w_in"]
    z, x, Bm, Cm, dt = _split_proj(proj, cfg)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    if seq_axis is None:
        xbc = seq_halo_conv1d(xbc, params["conv_w"], params["conv_b"], None)
    else:
        if t % n:
            raise ValueError(f"sequence length {t} does not split into the {n} shards of "
                             f"axis {seq_axis!r}")
        xbc = seq_halo_conv1d(xbc.view(b, n, t // n, -1), params["conv_w"], params["conv_b"],
                              seq_axis, seq_dim=2, shard_dim=1).view(b, t, -1)
    xbc = F.silu(xbc)
    gn = s.n_groups * s.d_state
    x, Bm, Cm = torch.split(xbc, [d_in, gn, gn], dim=-1)
    x = x.reshape(b, t, nh, s.head_dim)
    Bm = Bm.reshape(b, t, s.n_groups, s.d_state)
    Cm = Cm.reshape(b, t, s.n_groups, s.d_state)
    dtf = F.softplus(dt.to(torch.promote_types(dt.dtype, torch.float32)) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    if seq_axis is None:
        y, _ = ssd_scan(x, dtf, A, Bm, Cm, min(s.chunk, t))
    else:
        y, _ = _sharded_scan(ssd_scan, x, dtf, A, Bm, Cm, min(s.chunk, t // n), seq_axis)
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
