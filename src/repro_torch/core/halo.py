"""Halo (boundary-data) exchange between neighbouring tiles, on the virtual
tile mesh (``launch/mesh.py``).

The port of ``repro/core/halo.py``.  Tiles are the
leading dimensions of one tensor, ``(n, m, B, h, w, C)``, so the reference's
``lax.ppermute`` becomes a shift along a tile dimension: tile i receives
tile i-1's strip (or i+1's), and the edge tile receives zeros - which is
SAME-convolution zero padding at the map edges, as ``ppermute`` delivers it.

The 8-neighbour exchange is two axis-ordered rounds: rows first, then
columns over the row-extended array, so the corner blocks ride along in the
second round.  The packed exchanges of the overlap schedule return the
received strips without attaching them, so the executor can run the
interior conv of a group lead on owned data first (DESIGN.md §5).

Every exchange takes ``wire=``: ``None`` is today's shift, call for call;
a ``WireCtx`` compresses every strip (``wire_shift``, DESIGN.md §12): each
sending tile's strip is encoded on its own, the payload shifted, the
receiver decodes, and the backward ships the cotangent under error
feedback against a residual drawn from the ctx's ``EFBag``.

Non-uniform partitions (DESIGN.md §8-9) keep the tiles in a padded
layout: every tile holds ``max(sizes)`` slots, its valid data in the first
``sizes[i]``.  Every tile's size is a plan-time constant on the virtual
mesh, so each ragged exchange round is ONE precomputed index gather along
the tile dimension (``_ragged_gather``), whatever the number of tiles.

On ranks (``launch/mesh.py:DistTileMesh``, active through
``parallel/dist.py:tile_mesh_ctx``) each ``ppermute`` of the sync exchange
goes through ``dist.permute``: the block shifts locally and its edge
strips cross to the neighbour rank; the rounds keep their order, so the
corners still take two hops.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.launch.mesh import plan_constant
from repro_torch.optim.compression import WireCodec, ef_encode
from repro_torch.parallel.dist import active_tile_mesh, permute


def _shift_perm(n: int, direction: int) -> list[tuple[int, int]]:
    """Permutation sending shard i -> i+direction (no wraparound: edge tiles
    simply receive zeros, which matches SAME zero padding)."""
    if direction == 1:
        return [(i, i + 1) for i in range(n - 1)]
    if direction == -1:
        return [(i, i - 1) for i in range(1, n)]
    raise ValueError(direction)


def _shift(x: torch.Tensor, tile_dim: int, direction: int) -> torch.Tensor:
    """``ppermute`` along tile dimension ``tile_dim`` by ``direction`` tiles:
    receiver j gets sender j - direction's block, and the tiles with no
    sender get zeros.  +-1 is ``_shift_perm``'s neighbour shift; a pipeline
    hand-off moves a whole stage's tiles at once."""
    n = x.shape[tile_dim]
    k = abs(direction)
    if k == 0:
        raise ValueError(direction)
    if k >= n:
        return torch.zeros_like(x)
    zeros = torch.zeros_like(x.narrow(tile_dim, 0, k))
    if direction > 0:
        return torch.cat([zeros, x.narrow(tile_dim, 0, n - k)], dim=tile_dim)
    return torch.cat([x.narrow(tile_dim, k, n - k), zeros], dim=tile_dim)


def _move(t: torch.Tensor, tile_dim: int, shift) -> torch.Tensor:
    """A ``ppermute`` on the virtual mesh: ``_shift`` by ``shift`` tiles, or
    ``"swap"``, the 2-tile exchange ``[(0, 1), (1, 0)]``; on ranks,
    ``dist.permute`` of the rank's block."""
    mesh = active_tile_mesh()
    if mesh is not None:
        return permute(t, tile_dim, shift, mesh)
    if shift == "swap":
        return torch.flip(t, [tile_dim])
    return _shift(t, tile_dim, shift)


# ---------------------------------------------------------------------------
# Wire compression (DESIGN.md §12)
# ---------------------------------------------------------------------------


class EFBag:
    """Dispenser of error-feedback residual buffers for the recurring
    exchanges of one microbatch's pass, in deterministic call order.

    Modes: ``stateless`` hands out fresh zeros (forward-only paths and
    ``make_tiled_loss`` - no EF carry, every microbatch starts clean);
    ``collect`` also records each requested (shape, dtype) and keeps the
    zeros it hands out in ``drawn`` (the first microbatch of the deferred
    step, which finds the carry's layout as it runs); ``buffers`` hands out
    the supplied tensors in the same order (the carry).  The residuals of
    ``collect`` and ``buffers`` require grad: each exchange's new residual
    comes back as the gradient of its residual, as the reference's
    custom-VJP shifts return it.  ``emitted`` collects residuals produced
    eagerly (``send_boundary_sum_1d``'s primal-direction EF)."""

    def __init__(self, mode: str = "stateless", buffers=None):
        if mode not in ("stateless", "collect", "buffers"):
            raise ValueError(mode)
        self.mode = mode
        self.shapes: list[tuple[tuple[int, ...], Any]] = []
        self.buffers = list(buffers) if buffers is not None else None
        self.drawn: list[torch.Tensor] = []
        self.emitted: list[torch.Tensor] = []
        self._i = 0

    def take(self, shape, dtype=torch.float32, device=None) -> torch.Tensor:
        shape = tuple(shape)
        if self.mode == "collect":
            self.shapes.append((shape, dtype))
            buf = torch.zeros(shape, dtype=dtype, device=device, requires_grad=True)
            self.drawn.append(buf)
            return buf
        if self.mode == "buffers":
            if self._i >= len(self.buffers):
                raise ValueError(
                    f"EF bag exhausted after {len(self.buffers)} buffers: the "
                    "collect pass and this pass drew different exchange "
                    "counts (non-deterministic call order?)"
                )
            buf = self.buffers[self._i]
            self._i += 1
            if tuple(buf.shape) != shape:
                raise ValueError(
                    f"EF buffer {self._i - 1} shape {tuple(buf.shape)} != requested "
                    f"{shape}: collect/call order drifted"
                )
            return buf
        return torch.zeros(shape, dtype=dtype, device=device)

    def emit(self, new_res: torch.Tensor) -> None:
        self.emitted.append(new_res)


# Every exchanged tensor leads with the tile grid's two dimensions (n, m):
# the reference's devices, each of whose strips is encoded on its own.
GRID_DIMS = 2


@dataclasses.dataclass
class WireCtx:
    """Codec + residual dispenser threaded through the tiled executors down
    to every exchange.  ``None`` everywhere means uncompressed - today's
    code runs unchanged."""

    codec: WireCodec
    bag: EFBag


class _WireShift(torch.autograd.Function):
    """encode per sending tile -> move every payload leaf -> decode; the
    backward EF-encodes the cotangent against ``res`` (held by the forward
    receiver, the backward sender), moves it back and decodes, and returns
    the new residual as the gradient of ``res``."""

    @staticmethod
    def forward(ctx, x, res, tile_dim, shift, codec):
        ctx.save_for_backward(res)
        ctx.meta = (tile_dim, shift, codec)
        payload = codec.encode(x, GRID_DIMS)
        return codec.decode([_move(p, tile_dim, shift) for p in payload], x.shape, x.dtype,
                            GRID_DIMS)

    @staticmethod
    def backward(ctx, ct):
        (res,) = ctx.saved_tensors
        tile_dim, shift, codec = ctx.meta
        payload, new_res = ef_encode(codec, ct, res, GRID_DIMS)
        ct_x = None
        if ctx.needs_input_grad[0]:
            back = "swap" if shift == "swap" else -shift
            ct_x = codec.decode([_move(p, tile_dim, back) for p in payload], ct.shape, ct.dtype,
                                GRID_DIMS)
        return ct_x, new_res, None, None, None


def wire_shift(x: torch.Tensor, tile_dim: int, shift, wire: WireCtx | None) -> torch.Tensor:
    """``_move`` with optional wire compression.

    ``wire=None`` is literally the shift - codec=none plans run today's
    ops.  Otherwise every tile's strip is encoded on its own, each payload
    leaf is moved (a zero payload decodes to zeros, so the edge tiles'
    SAME padding survives) and decoded.  The forward is stateless: strips
    are activations, fresh every microbatch.  The backward ships the
    cotangent over the inverse move under error feedback; its residual
    comes from the ctx's bag, one per call (DESIGN.md §12) - except for a
    strip that takes no gradient (the input image's): its backward feeds
    nothing back, so its residual could reach no gradient, and none is
    drawn (the reference draws one, whose only use is its own next value).
    Drawing it would make the first conv compute its input's cotangent."""
    if wire is None:
        return _move(x, tile_dim, shift)
    res = _residual(wire, x.shape, x)
    return _WireShift.apply(x, res, tile_dim, shift, wire.codec)


def _residual(wire: WireCtx, shape, x: torch.Tensor) -> torch.Tensor:
    """The EF residual of one exchange of ``x``: from the bag, or zeros
    outside it when ``x`` takes no gradient (see ``wire_shift``)."""
    if x.requires_grad:
        return wire.bag.take(shape, device=x.device)
    return torch.zeros(shape, device=x.device)


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
    wire: WireCtx | None = None,
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
        parts.append(wire_shift(x.narrow(dim, size - halo_lo, halo_lo), tile_dim, +1, wire))
    parts.append(x)
    if halo_hi > 0:
        parts.append(wire_shift(x.narrow(dim, 0, halo_hi), tile_dim, -1, wire))
    if len(parts) == 1:
        return x
    return torch.cat(parts, dim=dim)


def halo_exchange_2d(
    x: torch.Tensor,
    halo: tuple[int, int, int, int],
    *,
    tile_dims: tuple[int, int] = (0, 1),
    dims: tuple[int, int] = (3, 4),
    wire: WireCtx | None = None,
) -> torch.Tensor:
    """2-D halo exchange (paper Fig. 4) over tiles ``(n, m, B, h, w, C)``.

    halo = (top, bottom, left, right).  The row round runs first; the column
    round then operates on the row-extended array so the corner blocks ride
    along - together the two rounds deliver data from all 8 neighbours.
    Under a codec the corners are therefore quantised twice, as in the
    reference."""
    top, bottom, left, right = halo
    y = halo_exchange_1d(x, top, bottom, tile_dim=tile_dims[0], dim=dims[0], wire=wire)
    return halo_exchange_1d(y, left, right, tile_dim=tile_dims[1], dim=dims[1], wire=wire)


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
    wire: WireCtx | None = None,
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
    one card, so no collective is counted here.  Under a codec the swap's
    packed lo+hi strip is encoded as one block per tile, the edge tiles'
    masked half included, as the reference ships it."""
    n = x.shape[tile_dim]
    if n == 1 or (halo_lo == 0 and halo_hi == 0):
        return _zeros_strip(x, halo_lo, dim), _zeros_strip(x, halo_hi, dim)
    size = x.shape[dim]
    _check_halo(halo_lo, halo_hi, size)
    if n == 2 and halo_lo > 0 and halo_hi > 0:
        send = torch.cat([x.narrow(dim, size - halo_lo, halo_lo), x.narrow(dim, 0, halo_hi)],
                         dim=dim)
        recv = wire_shift(send, tile_dim, "swap", wire)       # ppermute [(0, 1), (1, 0)]
        idx = _tile_index(recv, tile_dim)
        recv_lo = recv.narrow(dim, 0, halo_lo)
        recv_hi = recv.narrow(dim, halo_lo, halo_hi)
        recv_lo = torch.where(idx > 0, recv_lo, torch.zeros_like(recv_lo))
        recv_hi = torch.where(idx < n - 1, recv_hi, torch.zeros_like(recv_hi))
        return recv_lo, recv_hi
    recv_lo = (wire_shift(x.narrow(dim, size - halo_lo, halo_lo), tile_dim, +1, wire)
               if halo_lo > 0 else _zeros_strip(x, 0, dim))
    recv_hi = (wire_shift(x.narrow(dim, 0, halo_hi), tile_dim, -1, wire)
               if halo_hi > 0 else _zeros_strip(x, 0, dim))
    return recv_lo, recv_hi


def halo_exchange_2d_packed(
    x: torch.Tensor,
    halo: tuple[int, int, int, int],
    *,
    tile_dims: tuple[int, int] = (0, 1),
    dims: tuple[int, int] = (3, 4),
    wire: WireCtx | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Packed 2-D halo exchange for the overlap schedule:
    ``(x_rows, col_lo, col_hi)`` - the tiles with their top/bottom strips
    attached, and the separate left/right strips of that row-extended
    array (so they carry the corner blocks, as the 2-round exchange does).
    ``cat([col_lo, x_rows, col_hi], dims[1])`` is ``halo_exchange_2d``."""
    top, bottom, left, right = halo
    row_lo, row_hi = halo_exchange_1d_packed(x, top, bottom, tile_dim=tile_dims[0], dim=dims[0],
                                             wire=wire)
    parts = ([row_lo] if top > 0 else []) + [x] + ([row_hi] if bottom > 0 else [])
    x_rows = torch.cat(parts, dim=dims[0]) if len(parts) > 1 else x
    col_lo, col_hi = halo_exchange_1d_packed(x_rows, left, right, tile_dim=tile_dims[1],
                                             dim=dims[1], wire=wire)
    return x_rows, col_lo, col_hi


# ---------------------------------------------------------------------------
# Ragged exchanges: padded layout, one index gather per round
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=256)
def _ragged_index(
    sizes: tuple[int, ...], halo_lo: int, halo_hi: int, ext: int, keep_pad: bool
) -> tuple[int, ...]:
    """Source row of every output slot of a ragged exchange round, flattened
    over (tile, slot): tile i's ``ext`` output slots read rows of the
    ``(n * max(sizes) + 1)``-row stack of all tiles' slots, the last row
    being zero.  Output slots are ``[recv_lo | valid | recv_hi | tail]``:
    recv_lo the previous tile's last ``halo_lo`` valid rows, recv_hi the
    next tile's first ``halo_hi``, landing at ``halo_lo + sizes[i]``, both
    zero at the ends (SAME padding).  The tail reads the tile's own pad
    slots where ``keep_pad`` (the padded exchange: ``pad(x)`` with the
    strips written over it), else zero (the spec exchange)."""
    n, smax = len(sizes), max(sizes)
    zero = n * smax
    out = []
    for i, s in enumerate(sizes):
        row = [zero] * ext
        own = smax if keep_pad else s
        for r in range(own):
            row[halo_lo + r] = i * smax + r
        for r in range(halo_hi):
            row[halo_lo + s + r] = (i + 1) * smax + r if i < n - 1 else zero
        for r in range(halo_lo):
            row[r] = (i - 1) * smax + sizes[i - 1] - halo_lo + r if i > 0 else zero
        out.extend(row)
    return tuple(out)


def _ragged_gather(x: torch.Tensor, index: tuple[int, ...], ext: int, *, tile_dim: int,
                   dim: int) -> torch.Tensor:
    """Rows of ``x`` picked by a flat ``(tile, slot)`` index (``_ragged_index``)
    along ``tile_dim`` x ``dim``: one ``index_select`` over all tiles, whose
    autograd adjoint is the scatter-add the reference's AD derives for its
    strips."""
    xt = x.movedim((tile_dim, dim), (0, 1))
    n, smax, rest = xt.shape[0], xt.shape[1], xt.shape[2:]
    flat = xt.reshape(n * smax, *rest)
    flat = torch.cat([flat, flat.new_zeros((1, *rest))])
    out = flat.index_select(0, plan_constant(index, x.device)).reshape(n, ext, *rest)
    return out.movedim((0, 1), (tile_dim, dim))


@functools.lru_cache(maxsize=256)
def _send_up_index(sizes: tuple[int, ...], halo_lo: int) -> tuple[int, ...]:
    """The strip each tile sends up, as a ``_ragged_gather`` index: tile
    i's last ``halo_lo`` valid rows ``[sizes[i] - halo_lo, sizes[i])``."""
    smax = max(sizes)
    return tuple(i * smax + s - halo_lo + r for i, s in enumerate(sizes) for r in range(halo_lo))


@functools.lru_cache(maxsize=256)
def _ragged_place_index(
    sizes: tuple[int, ...], halo_lo: int, halo_hi: int, ext: int, keep_pad: bool
) -> tuple[int, ...]:
    """``_ragged_index``'s output slots read from each tile's own
    ``[x (max(sizes)) | recv_lo (halo_lo) | recv_hi (halo_hi)]`` rows
    instead of its neighbours': the placement of strips that were shipped
    on their own (the wired exchange)."""
    n, smax = len(sizes), max(sizes)
    e = smax + halo_lo + halo_hi
    zero = n * e
    out = []
    for i, s in enumerate(sizes):
        row = [zero] * ext
        for r in range(smax if keep_pad else s):
            row[halo_lo + r] = i * e + r
        for r in range(halo_hi):
            row[halo_lo + s + r] = i * e + smax + halo_lo + r
        for r in range(halo_lo):
            row[r] = i * e + smax + r
        out.extend(row)
    return tuple(out)


def _ragged_round(x, halo_lo, halo_hi, sizes, *, tile_dim, dim, out_extent, keep_pad, what,
                  wire=None):
    smax = max(sizes)
    if x.shape[dim] != smax or x.shape[tile_dim] != len(sizes):
        raise ValueError(
            f"{what} exchange expects {len(sizes)} tiles of padded extent {smax} on "
            f"dims ({tile_dim}, {dim}); got shape {tuple(x.shape)}"
        )
    ext = out_extent if out_extent is not None else smax + halo_lo + halo_hi
    if ext < halo_lo + smax + halo_hi:
        raise ValueError(f"out_extent {ext} < {halo_lo}+{smax}+{halo_hi}")
    if min(sizes) < max(halo_lo, halo_hi):
        raise ValueError(
            f"halo ({halo_lo}, {halo_hi}) exceeds the smallest tile {min(sizes)}: the "
            "exchange ships one neighbour strip per side"
        )
    if halo_lo == 0 and halo_hi == 0 and ext == smax:
        return x
    sizes = tuple(sizes)
    if wire is None:
        index = _ragged_index(sizes, halo_lo, halo_hi, ext, keep_pad)
        return _ragged_gather(x, index, ext, tile_dim=tile_dim, dim=dim)
    # Under a codec each tile's send-down strip (its first halo_hi rows)
    # and send-up strip (its last halo_lo valid rows) is shipped on its own,
    # as the reference ships them - the padded exchange the hi strip first,
    # the spec one the lo strip first - then placed by one gather.
    def send_up():
        up = _ragged_gather(x, _send_up_index(sizes, halo_lo), halo_lo, tile_dim=tile_dim,
                            dim=dim)
        return wire_shift(up, tile_dim, +1, wire)

    def send_down():
        return wire_shift(x.narrow(dim, 0, halo_hi), tile_dim, -1, wire)

    recv_lo = recv_hi = None
    if keep_pad:
        recv_hi = send_down() if halo_hi > 0 else None
        recv_lo = send_up() if halo_lo > 0 else None
    else:
        recv_lo = send_up() if halo_lo > 0 else None
        recv_hi = send_down() if halo_hi > 0 else None
    parts = [x] + [r for r in (recv_lo, recv_hi) if r is not None]
    index = _ragged_place_index(sizes, halo_lo, halo_hi, ext, keep_pad)
    return _ragged_gather(torch.cat(parts, dim=dim), index, ext, tile_dim=tile_dim, dim=dim)


def halo_exchange_1d_ragged(
    x: torch.Tensor,
    halo_lo: int,
    halo_hi: int,
    sizes: tuple[int, ...],
    *,
    tile_dim: int,
    dim: int,
    out_extent: int | None = None,
    wire: WireCtx | None = None,
) -> torch.Tensor:
    """Halo exchange over ragged tiles in the padded layout (DESIGN.md §8).

    Tile i holds ``max(sizes)`` slots along ``dim``, valid data in
    ``[0, sizes[i])`` and zeros beyond - the padded-tile invariant the
    padded executor keeps.  Returns extent ``out_extent`` (default
    ``halo_lo + max(sizes) + halo_hi``) laid out ``[recv_lo | valid |
    recv_hi | zeros]``: the strip a tile sends up is its last ``halo_lo``
    VALID rows, and the received hi strip lands at ``halo_lo + sizes[i]``,
    right after the valid data.  Beyond it the tile's own (zero) pad slots
    carry over, so pad slots stay exactly zero.  Needs ``min(sizes) >=
    max(halo_lo, halo_hi)``."""
    return _ragged_round(x, halo_lo, halo_hi, sizes, tile_dim=tile_dim, dim=dim,
                         out_extent=out_extent, keep_pad=True, what="ragged", wire=wire)


def halo_exchange_2d_ragged(
    x: torch.Tensor,
    halo: tuple[int, int, int, int],
    row_sizes: tuple[int, ...],
    col_sizes: tuple[int, ...],
    *,
    tile_dims: tuple[int, int] = (0, 1),
    dims: tuple[int, int] = (3, 4),
    out_extents: tuple[int, int] | None = None,
    wire: WireCtx | None = None,
) -> torch.Tensor:
    """2-D padded ragged exchange: rows first, then columns over the
    row-extended tiles, so the corners ride the second round.  Tiles of one
    tile row share its row layout, so the column strips align."""
    top, bottom, left, right = halo
    oe = out_extents or (None, None)
    y = halo_exchange_1d_ragged(x, top, bottom, row_sizes, tile_dim=tile_dims[0], dim=dims[0],
                                out_extent=oe[0], wire=wire)
    return halo_exchange_1d_ragged(y, left, right, col_sizes, tile_dim=tile_dims[1],
                                   dim=dims[1], out_extent=oe[1], wire=wire)


def _switch_by_size(row_sizes: tuple[int, ...], col_sizes: tuple[int, ...]):
    """The shape classes of a ragged grid, as ``[((r, c), tiles), ...]``:
    each distinct (row, col) tile extent with the flat indices ``i * m + j``
    of its tiles, rows and columns deduplicated in first-appearance order
    (``dedup_axis_shapes``).  The reference's ``_switch_by_size`` runs ONE
    static program per distinct shape, chosen per device by ``lax.switch``
    on a branch read from a static table at the traced ``axis_index``
    (``static_table_lookup``, a one-hot sum that keeps the switch free of
    ``dynamic_slice``).  On the virtual mesh every tile index is a Python
    int, so both roles - a tile's class, and one program per class - are
    this grouping: every tile of a class runs in the same call, and the
    spec executor issues one conv per class and layer, not one per tile."""
    from repro_torch.core.tiling import dedup_axis_shapes

    rtab, runiq = dedup_axis_shapes(row_sizes)
    ctab, cuniq = dedup_axis_shapes(col_sizes)
    m = len(col_sizes)
    return [
        ((r, c), tuple(i * m + j for i in range(len(row_sizes)) for j in range(m)
                       if rtab[i] == ri and ctab[j] == ci))
        for ri, r in enumerate(runiq)
        for ci, c in enumerate(cuniq)
    ]


def halo_exchange_1d_spec(
    x: torch.Tensor,
    halo_lo: int,
    halo_hi: int,
    sizes: tuple[int, ...],
    *,
    tile_dim: int,
    dim: int,
    out_extent: int | None = None,
    wire: WireCtx | None = None,
) -> torch.Tensor:
    """Shape-specialised exchange over ragged tiles (DESIGN.md §9): the
    contract of ``halo_exchange_1d_ragged``, except that only each tile's
    valid rows are read - ``[recv_lo?, valid, recv_hi?]`` zero-padded to the
    canonical extent - so whatever the spec executor leaves in a tile's pad
    slots never reaches the result."""
    return _ragged_round(x, halo_lo, halo_hi, sizes, tile_dim=tile_dim, dim=dim,
                         out_extent=out_extent, keep_pad=False, what="spec", wire=wire)


def halo_exchange_2d_spec(
    x: torch.Tensor,
    halo: tuple[int, int, int, int],
    row_sizes: tuple[int, ...],
    col_sizes: tuple[int, ...],
    *,
    tile_dims: tuple[int, int] = (0, 1),
    dims: tuple[int, int] = (3, 4),
    out_extents: tuple[int, int] | None = None,
    wire: WireCtx | None = None,
) -> torch.Tensor:
    """2-D shape-specialised exchange: rows first, then columns over the
    row-extended tiles (corners ride the second round)."""
    top, bottom, left, right = halo
    oe = out_extents or (None, None)
    y = halo_exchange_1d_spec(x, top, bottom, row_sizes, tile_dim=tile_dims[0], dim=dims[0],
                              out_extent=oe[0], wire=wire)
    return halo_exchange_1d_spec(y, left, right, col_sizes, tile_dim=tile_dims[1], dim=dims[1],
                                 out_extent=oe[1], wire=wire)


def send_boundary_sum_1d(
    x: torch.Tensor,
    overlap_lo: int,
    overlap_hi: int,
    *,
    tile_dim: int,
    dim: int,
    wire: WireCtx | None = None,
) -> torch.Tensor:
    """Adjoint of ``halo_exchange_1d``: fold halo regions back onto their
    owners and sum.  ``x`` carries ``overlap_lo``/``overlap_hi`` rows at each
    end of every tile that belong to the neighbouring tiles; they are
    shipped back and added onto the neighbour's interior.  (Autograd derives
    exactly this for the backward pass - provided for explicit schedules
    and tests.)

    Under ``wire`` the shipped strips are cotangents of a recurring
    exchange, so they ride error feedback in the primal direction: each is
    quantised against a residual drawn from the bag, and the new residual
    is pushed to ``wire.bag.emitted`` in the order the bag was drawn from."""
    size = x.shape[dim]
    core = x.narrow(dim, overlap_lo, size - overlap_lo - overlap_hi)

    def ship(strip, direction):
        if wire is None:
            return _shift(strip, tile_dim, direction)
        res = wire.bag.take(strip.shape, device=strip.device)
        payload, new_res = ef_encode(wire.codec, strip, res, GRID_DIMS)
        wire.bag.emit(new_res)
        recv = [_shift(p, tile_dim, direction) for p in payload]
        return wire.codec.decode(recv, strip.shape, strip.dtype, GRID_DIMS)

    if overlap_lo > 0:
        up = ship(x.narrow(dim, 0, overlap_lo), -1)        # belongs to the previous tile
        pad = [0, 0] * (x.dim() - 1 - dim) + [core.shape[dim] - overlap_lo, 0]
        core = core + torch.nn.functional.pad(up, pad)
    if overlap_hi > 0:
        down = ship(x.narrow(dim, size - overlap_hi, overlap_hi), +1)
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, core.shape[dim] - overlap_hi]
        core = core + torch.nn.functional.pad(down, pad)
    return core
