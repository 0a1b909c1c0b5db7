"""Sequence-dimension operators of the LM mixers: ``repro/core/sequence.py``
on the virtual mesh.

The paper's tiling and halo technique on the sequence dimension: Mamba2's
causal conv takes a left halo of K-1 tokens, the SSD scan hands a
(decay, state) summary from shard to shard, and sliding-window attention
takes the previous shard's last W keys and values.

The reference runs each function inside ``shard_map`` with the sequence
axis named ``axis``.  Here every shard lives on one device as a dimension of
the tensor, ``shard_dim``, as ``tile_dim`` is in ``core/halo.py``:
``axis`` names an axis of the active virtual mesh (``parallel/api.py``) and
``shard_dim`` must have its size (``_shard_count`` checks).  A ``ppermute``
is ``halo.py``'s zero-filled shift along ``shard_dim``, and
``lax.axis_index`` an ``arange`` along it.  ``axis=None`` runs unsharded, as
the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.core.halo import _shift, halo_exchange_1d
from repro_torch.parallel.api import active_mesh


def _mesh_axis_size(axis: str) -> int:
    mesh = active_mesh()
    if mesh is None or axis not in mesh.shape:
        raise ValueError(f"axis {axis!r} is not an axis of the active virtual mesh "
                         f"({None if mesh is None else mesh.shape})")
    return mesh.shape[axis]


def _shard_count(axis: str, x: torch.Tensor, shard_dim) -> int:
    """The size of mesh axis ``axis``, which ``x``'s ``shard_dim`` must have."""
    n = _mesh_axis_size(axis)
    if shard_dim is None:
        raise ValueError(f"a sharded call over axis {axis!r} needs the shard dimension "
                         "(shard_dim)")
    if x.shape[shard_dim] != n:
        raise ValueError(f"dimension {shard_dim} of {tuple(x.shape)} holds the shards of "
                         f"axis {axis!r}, which has {n}")
    return n


def _shard_index(x: torch.Tensor, shard_dim: int) -> torch.Tensor:
    """Each shard's index along ``shard_dim``, shaped to broadcast against
    ``x`` (the reference's ``lax.axis_index``)."""
    shape = [1] * x.dim()
    shape[shard_dim] = x.shape[shard_dim]
    return torch.arange(x.shape[shard_dim], device=x.device).reshape(shape)


# ---------------------------------------------------------------------------
# Causal conv1d with a sequence halo (Mamba2's conv before the SSM)
# ---------------------------------------------------------------------------


def seq_halo_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None,
    axis: str | None,
    *,
    seq_dim: int = 1,
    shard_dim: int | None = None,
) -> torch.Tensor:
    """Depthwise causal conv1d.  x: (B, T, D), or its shards with a shard
    dimension (``(B, S, T/S, D)``, ``shard_dim=1``, ``seq_dim=2``); w: (K, D)
    depthwise taps; output x's shape.  Each shard's left halo of K-1 tokens
    comes from the previous shard (zeros for the first: causal padding).  As
    the reference: a sum of K shifted slices, each product and sum in x's
    type."""
    k = w.shape[0]
    t = x.shape[seq_dim]
    if axis is not None:
        _shard_count(axis, x, shard_dim)
        xh = halo_exchange_1d(x, k - 1, 0, tile_dim=shard_dim, dim=seq_dim)
    else:
        pad_shape = list(x.shape)
        pad_shape[seq_dim] = k - 1
        xh = torch.cat([x.new_zeros(pad_shape), x], dim=seq_dim)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xh.narrow(seq_dim, i, t) * w[i]
    if b is not None:
        out = out + b
    return out


# ---------------------------------------------------------------------------
# Cross-shard associative state combine (SSD chunk-state handoff)
# ---------------------------------------------------------------------------


def seq_scan_combine(decay: torch.Tensor, state: torch.Tensor, axis: str, *,
                     shard_dim: int = 0) -> torch.Tensor:
    """Each shard's *incoming* SSM state from the per-shard summaries:
    shard i's (decay_i, state_i) maps an incoming state h to
    ``decay_i * h + state_i``, so shard i receives

        in_i = sum_{j<i} (prod_{j<k<i} decay_k) * state_j,

    the exclusive associative prefix.  The reference all-gathers the
    summaries and sums that prefix on every shard; here every shard's are
    present already, and the prefix is the recurrence
    ``in_{i+1} = decay_i * in_i + state_i`` from ``in_0 = 0``.  ``decay``
    broadcasts against ``state`` as given; both hold the shards along
    ``shard_dim``."""
    n = _shard_count(axis, state, shard_dim)
    decays = decay.movedim(shard_dim, 0)
    states = state.movedim(shard_dim, 0)
    out = [torch.zeros_like(states[0])]
    for i in range(n - 1):
        out.append(decays[i] * out[-1] + states[i])
    return torch.stack(out).movedim(0, shard_dim)


def seq_scan_combine_hops(decay: torch.Tensor, state: torch.Tensor, axis: str, *,
                          shard_dim: int = 0) -> torch.Tensor:
    """``seq_scan_combine`` by a doubling scan, the reference's
    ``ppermute`` rounds: round r ships each (decay, state) summary 2^r
    shards on and composes ``(d2, s2) o (d1, s1) = (d1*d2, d2*s1 + s2)``;
    after ceil(log2 n) rounds each shard holds its inclusive prefix, and one
    +1 shift makes it the exclusive one.  ``decay`` has ``state``'s leading
    dimensions (``(B, S, H)`` against ``(B, S, H, N, P)``)."""
    n = _shard_count(axis, state, shard_dim)
    d, s = decay, state
    d_idx, s_idx = _shard_index(d, shard_dim), _shard_index(s, shard_dim)
    dx = d.reshape(d.shape + (1,) * (s.dim() - d.dim()))   # broadcast over state
    shift = 1
    while shift < n:
        d_in = _shift(d, shard_dim, shift)       # zeros where no sender
        s_in = _shift(s, shard_dim, shift)
        # compose the incoming prefix (d_in, s_in) before the local (d, s)
        d_new = torch.where(d_idx >= shift, d * d_in, d)
        s_new = torch.where(s_idx >= shift, dx * s_in + s, s)
        d, s = d_new, s_new
        dx = d.reshape(d.shape + (1,) * (s.dim() - d.dim()))
        shift *= 2
    # exclusive prefix = inclusive prefix of the left neighbour
    return _shift(s, shard_dim, 1)


# ---------------------------------------------------------------------------
# Sliding-window attention KV halo
# ---------------------------------------------------------------------------


def swa_kv_halo(
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    axis: str | None,
    *,
    seq_dim: int = 1,
    shard_dim: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Prepend the previous shard's last ``window`` keys and values:
    ``(k_ext, v_ext, halo)`` with ``halo = min(window, local T)`` tokens
    (zeros on the first shard, masked by the positions of
    ``swa_position_ids``)."""
    t_local = k.shape[seq_dim]
    halo = min(window, t_local)
    if axis is None:
        shape = list(k.shape)
        shape[seq_dim] = halo
        return (torch.cat([k.new_zeros(shape), k], dim=seq_dim),
                torch.cat([v.new_zeros(shape), v], dim=seq_dim), halo)
    _shard_count(axis, k, shard_dim)
    k_ext = halo_exchange_1d(k, halo, 0, tile_dim=shard_dim, dim=seq_dim)
    v_ext = halo_exchange_1d(v, halo, 0, tile_dim=shard_dim, dim=seq_dim)
    return k_ext, v_ext, halo


def swa_position_ids(t_local: int, halo: int, axis: str | None, *,
                     device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Global positions of the queries (``t_local``) and extended keys
    (``halo + t_local``) for the window and causal masks, int32; under
    ``axis`` one row per shard, ``(S, ...)``, shard i starting at
    ``i * t_local``."""
    q = torch.arange(t_local, dtype=torch.int32, device=device)
    kk = torch.arange(t_local + halo, dtype=torch.int32, device=device) - halo
    if axis is None:
        return q, kk
    base = torch.arange(_mesh_axis_size(axis), dtype=torch.int32, device=device)[:, None] * t_local
    return base + q, base + kk
