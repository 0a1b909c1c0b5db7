"""Halo (boundary-data) exchange between neighbouring tiles, on the virtual
tile mesh (``launch/mesh.py``).

The port of the uniform part of ``repro/core/halo.py``.  Tiles are the
leading dimensions of one tensor, ``(n, m, B, h, w, C)``, so the reference's
``lax.ppermute`` becomes a shift along a tile dimension: tile i receives
tile i-1's strip (or i+1's), and the edge tile receives zeros - which is
SAME-convolution zero padding at the map edges, as ``ppermute`` delivers it.

The 8-neighbour exchange is two axis-ordered rounds: rows first, then
columns over the row-extended array, so the corner blocks ride along in the
second round.  Wire codecs (``WireCtx``) are later work (ROADMAP A.14).
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
    if max(halo_lo, halo_hi) > size:
        raise ValueError(
            f"halo ({halo_lo}, {halo_hi}) exceeds the tile extent {size}: the "
            "exchange ships one neighbour strip per side"
        )
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
