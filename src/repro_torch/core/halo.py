"""Halo (boundary-data) exchange between neighbouring tiles, on the virtual
tile mesh (``launch/mesh.py``).

The port of the uniform part of ``repro/core/halo.py``.  Tiles are the
leading dimensions of one tensor, ``(n, m, B, h, w, C)``, so the reference's
``lax.ppermute`` becomes a shift along a tile dimension: tile i receives
tile i-1's strip (or i+1's), and the edge tile receives zeros - which is
SAME-convolution zero padding at the map edges, as ``ppermute`` delivers it.

The 8-neighbour exchange is two axis-ordered rounds: rows first, then
columns over the row-extended array, so the corner blocks ride along in the
second round.  The packed exchanges of the overlap schedule return the
received strips without attaching them, so the executor can run the
interior conv of a group lead on owned data first (DESIGN.md §5).  Wire
codecs (``WireCtx``) are later work (ROADMAP A.14).
"""
from __future__ import annotations

import torch


def _shift_perm(n: int, direction: int) -> list[tuple[int, int]]:
    """Permutation sending shard i -> i+direction (no wraparound: edge tiles
    simply receive zeros, which matches SAME zero padding)."""
    if direction == 1:
        return [(i, i + 1) for i in range(n - 1)]
    if direction == -1:
        return [(i, i - 1) for i in range(1, n)]
    raise ValueError(direction)


def _shift(x: torch.Tensor, tile_dim: int, direction: int) -> torch.Tensor:
    """``ppermute(x, _shift_perm(n, direction))`` along tile dimension
    ``tile_dim``: receiver j gets sender j - direction's block, and the
    tile with no sender gets zeros."""
    n = x.shape[tile_dim]
    if direction not in (1, -1):
        raise ValueError(direction)
    zeros = torch.zeros_like(x.narrow(tile_dim, 0, 1))
    if n == 1:
        return zeros
    if direction == 1:
        return torch.cat([zeros, x.narrow(tile_dim, 0, n - 1)], dim=tile_dim)
    return torch.cat([x.narrow(tile_dim, 1, n - 1), zeros], dim=tile_dim)


def _check_halo(halo_lo: int, halo_hi: int, size: int) -> None:
    if max(halo_lo, halo_hi) > size:
        raise ValueError(
            f"halo ({halo_lo}, {halo_hi}) exceeds the tile extent {size}: the "
            "exchange ships one neighbour strip per side"
        )


def halo_exchange_1d(
    x: torch.Tensor,
    halo_lo: int,
    halo_hi: int,
    *,
    tile_dim: int,
    dim: int,
) -> torch.Tensor:
    """Extend every tile along spatial ``dim`` with ``halo_lo`` rows from the
    previous tile and ``halo_hi`` rows from the next one along ``tile_dim``
    (zeros at the ends).  The result's ``dim`` extent is
    ``x.shape[dim] + halo_lo + halo_hi``."""
    size = x.shape[dim]
    _check_halo(halo_lo, halo_hi, size)
    parts = []
    if halo_lo > 0:
        # the strip the *previous* tile sends us: its last halo_lo rows
        parts.append(_shift(x.narrow(dim, size - halo_lo, halo_lo), tile_dim, +1))
    parts.append(x)
    if halo_hi > 0:
        parts.append(_shift(x.narrow(dim, 0, halo_hi), tile_dim, -1))
    if len(parts) == 1:
        return x
    return torch.cat(parts, dim=dim)


def halo_exchange_2d(
    x: torch.Tensor,
    halo: tuple[int, int, int, int],
    *,
    tile_dims: tuple[int, int] = (0, 1),
    dims: tuple[int, int] = (3, 4),
) -> torch.Tensor:
    """2-D halo exchange (paper Fig. 4) over tiles ``(n, m, B, h, w, C)``.

    halo = (top, bottom, left, right).  The row round runs first; the column
    round then operates on the row-extended array so the corner blocks ride
    along - together the two rounds deliver data from all 8 neighbours."""
    top, bottom, left, right = halo
    y = halo_exchange_1d(x, top, bottom, tile_dim=tile_dims[0], dim=dims[0])
    return halo_exchange_1d(y, left, right, tile_dim=tile_dims[1], dim=dims[1])


def _zeros_strip(x: torch.Tensor, width: int, dim: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[dim] = width
    return x.new_zeros(shape)


def _tile_index(x: torch.Tensor, tile_dim: int) -> torch.Tensor:
    """Each tile's index along ``tile_dim``, shaped to broadcast against
    ``x`` - the reference's ``lax.axis_index``."""
    shape = [1] * x.dim()
    shape[tile_dim] = x.shape[tile_dim]
    return torch.arange(x.shape[tile_dim], device=x.device).reshape(shape)


def halo_exchange_1d_packed(
    x: torch.Tensor,
    halo_lo: int,
    halo_hi: int,
    *,
    tile_dim: int,
    dim: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed halo exchange: ``(recv_lo, recv_hi)``, the strips every tile
    receives from its previous and next neighbour along ``tile_dim``,
    *without* attaching them to ``x`` (zeros at the ends).

    The two branches are the reference's.  On a 2-tile axis both neighbours
    are the same tile, so the lo and hi strips travel packed in one swap
    and the edge strips are zeroed by tile index, as ``axis_index`` masks
    them in the reference; on a longer axis each strip is its own shift.
    Both give the same strips.  The reference counts one collective per
    swap and two per longer axis; on the virtual mesh a strip is a copy on
    one card, so no collective is counted here."""
    n = x.shape[tile_dim]
    if n == 1 or (halo_lo == 0 and halo_hi == 0):
        return _zeros_strip(x, halo_lo, dim), _zeros_strip(x, halo_hi, dim)
    size = x.shape[dim]
    _check_halo(halo_lo, halo_hi, size)
    if n == 2 and halo_lo > 0 and halo_hi > 0:
        send = torch.cat([x.narrow(dim, size - halo_lo, halo_lo), x.narrow(dim, 0, halo_hi)],
                         dim=dim)
        recv = torch.flip(send, [tile_dim])       # ppermute [(0, 1), (1, 0)]
        idx = _tile_index(recv, tile_dim)
        recv_lo = recv.narrow(dim, 0, halo_lo)
        recv_hi = recv.narrow(dim, halo_lo, halo_hi)
        recv_lo = torch.where(idx > 0, recv_lo, torch.zeros_like(recv_lo))
        recv_hi = torch.where(idx < n - 1, recv_hi, torch.zeros_like(recv_hi))
        return recv_lo, recv_hi
    recv_lo = (_shift(x.narrow(dim, size - halo_lo, halo_lo), tile_dim, +1)
               if halo_lo > 0 else _zeros_strip(x, 0, dim))
    recv_hi = (_shift(x.narrow(dim, 0, halo_hi), tile_dim, -1)
               if halo_hi > 0 else _zeros_strip(x, 0, dim))
    return recv_lo, recv_hi


def halo_exchange_2d_packed(
    x: torch.Tensor,
    halo: tuple[int, int, int, int],
    *,
    tile_dims: tuple[int, int] = (0, 1),
    dims: tuple[int, int] = (3, 4),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed 2-D halo exchange for the overlap schedule:
    ``(x_rows, col_lo, col_hi)`` - the tiles with their top/bottom strips
    attached, and the separate left/right strips of that row-extended
    array (so they carry the corner blocks, as the 2-round exchange does).
    ``cat([col_lo, x_rows, col_hi], dims[1])`` is ``halo_exchange_2d``."""
    top, bottom, left, right = halo
    row_lo, row_hi = halo_exchange_1d_packed(x, top, bottom, tile_dim=tile_dims[0], dim=dims[0])
    parts = ([row_lo] if top > 0 else []) + [x] + ([row_hi] if bottom > 0 else [])
    x_rows = torch.cat(parts, dim=dims[0]) if len(parts) > 1 else x
    col_lo, col_hi = halo_exchange_1d_packed(x_rows, left, right, tile_dim=tile_dims[1],
                                             dim=dims[1])
    return x_rows, col_lo, col_hi
