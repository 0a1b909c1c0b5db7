"""The virtual tile mesh: an n x m tile grid held on ONE device.

The JAX reference runs ``shard_map`` over an (n, m) device mesh, one tile
per device.  One H100 is one device, so the port keeps the tile grid as
leading tensor dimensions instead: activations live as
``(n, m, B, h, w, C)``, a ``ppermute`` between neighbouring tiles is a
zero-filled shift along the n or m dimension (``core/halo.py``), and each
conv runs once over all tiles reshaped to ``(n*m*B, h, w, C)`` - one kernel
launch per conv layer per dispatch, not n*m.

A non-uniform partition (DESIGN.md §8) packs the map into the padded tile
layout ``(n, m, B, Hmax, Wmax, C)``: tile (i, j) holds its span of the map
in its first ``rows[i] x cols[j]`` slots and zeros beyond - one index
gather per axis (``pack_axis``, the reference's ``fusion._pack_axis``),
undone by ``unpack_axis``.  The reference packs a spec plan inside the
shard boundary (``_shard_pack_grid``) and a padded plan on the host
(``_pack_grid``); the virtual mesh has no boundary, so both take this one.

The LM side's mesh is a ``VirtualMesh`` of named axes (the reference's
``jax.sharding.Mesh``, of which it keeps ``shape``): ``parallel/api.py``
resolves logical axes against it, and a sequence-sharded mixer keeps its
shards as a tensor dimension of the axis's size (``core/sequence.py``).
``make_production_mesh`` and ``make_local_mesh`` are the reference's
topologies: the 16 x 16 pod (x 2 pods), and the local devices as (1, n).

``make_dist_tile_mesh`` spreads the tile grid over the ranks of a
``torch.distributed`` group (``parallel/dist.py``): each rank holds a
block of it, ``(n/Rr, m/Rc, B, h, w, C)``, and the exchanges and sums cross
ranks.  It is a ``TileMesh`` to its callers: ``split`` gives the rank's
block, ``merge`` gathers every rank's for an output.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.parallel import dist as tdist


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the default of every
    entry point) raises when no card is present - the caller must ask for
    ``"cpu"`` explicitly, so a run never lands on the CPU by accident."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain torch path on the CPU"
        )
    return dev


@functools.lru_cache(maxsize=1024)
def plan_constant(values: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A plan-time int table (tile indices, sizes, offsets, gather indices)
    as a tensor on ``device``, made once: a fresh ``torch.tensor(...,
    device="cuda")`` copies from pageable host memory and waits for the
    copy at every call, which would stall the host before every ragged
    exchange, pack and class conv.  Callers never write to it.  It is made
    outside inference mode even when first asked for inside it (a serve
    step), so a later training step can save it for its backward."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=torch.long, device=device)


@functools.lru_cache(maxsize=64)
def _axis_index(sizes: tuple[int, ...], pack: bool) -> tuple[int, ...]:
    """Source positions along one axis: packing reads map row ``off_k + r``
    into slot ``k * max + r`` (the zero row ``sum(sizes)`` past a tile's
    size); unpacking reads the valid slots back in map order."""
    mx, out, off = max(sizes), [], 0
    for k, s in enumerate(sizes):
        if pack:
            out += [off + r if r < s else sum(sizes) for r in range(mx)]
        else:
            out += [k * mx + r for r in range(s)]
        off += s
    return tuple(out)


def pack_axis(a: torch.Tensor, sizes: tuple[int, ...], dim: int) -> torch.Tensor:
    """Global -> padded-tile layout along ``dim``: each tile's span zero-padded
    to the largest tile, tiles concatenated (``repro``'s ``_pack_axis``).
    Uniform sizes return ``a`` itself."""
    if len(set(sizes)) == 1:
        return a
    if a.shape[dim] != sum(sizes):
        raise ValueError(f"axis {dim} of {tuple(a.shape)} is not the partition's {sum(sizes)}")
    shape = list(a.shape)
    shape[dim] = 1
    az = torch.cat([a, a.new_zeros(shape)], dim=dim)
    return az.index_select(dim, plan_constant(_axis_index(tuple(sizes), True), a.device))


def unpack_axis(a: torch.Tensor, sizes: tuple[int, ...], dim: int) -> torch.Tensor:
    """Padded-tile -> global layout along ``dim``: each tile's valid slots,
    in map order (``repro``'s ``_unpack_axis``)."""
    if len(set(sizes)) == 1:
        return a
    return a.index_select(dim, plan_constant(_axis_index(tuple(sizes), False), a.device))


def pack_grid(a, rows, cols, dims=(1, 2)):
    return pack_axis(pack_axis(a, rows, dims[0]), cols, dims[1])


def unpack_grid(a, rows, cols, dims=(1, 2)):
    return unpack_axis(unpack_axis(a, rows, dims[0]), cols, dims[1])


@dataclasses.dataclass(frozen=True)
class TileMesh:
    """n x m tile grid on one device (the counterpart of a 2-D jax Mesh)."""

    n: int
    m: int
    device: torch.device

    def split(self, x: torch.Tensor, rows: tuple[int, ...] | None = None,
              cols: tuple[int, ...] | None = None) -> torch.Tensor:
        """Global (B, H, W, C) -> tiles (n, m, B, H/n, W/m, C).  Given the
        partition's per-tile ``rows`` and ``cols``, a ragged one packs into
        the padded layout (n, m, B, max(rows), max(cols), C) instead."""
        if rows is not None:
            if (len(rows), len(cols)) != (self.n, self.m):
                raise ValueError(f"partition {rows} x {cols} is not {self.n}x{self.m} tiles")
            x = pack_grid(x, rows, cols)
        b, h, w, c = x.shape
        if h % self.n or w % self.m:
            raise ValueError(
                f"map {h}x{w} does not split evenly over the {self.n}x{self.m} grid"
            )
        t = x.reshape(b, self.n, h // self.n, self.m, w // self.m, c)
        return t.permute(1, 3, 0, 2, 4, 5).contiguous()

    def merge(self, t: torch.Tensor, rows: tuple[int, ...] | None = None,
              cols: tuple[int, ...] | None = None) -> torch.Tensor:
        """Tiles (n, m, B, h, w, C) -> global (B, n*h, m*w, C), row-major
        tile order (the inverse of ``split``).  Given ``rows`` and ``cols``,
        padded ragged tiles give back each tile's valid window."""
        n, m, b, h, w, c = t.shape
        out = t.permute(2, 0, 3, 1, 4, 5).reshape(b, n * h, m * w, c)
        return out if rows is None else unpack_grid(out, rows, cols)

    def split_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Global (B, H, W, C) -> batch blocks (n, m, B/(n*m), H, W, C) of
        full maps: tile (i, j) holds block i*m + j, the data layout of a
        hybrid plan's tail (the counterpart of ``P((row_axis, col_axis))``)."""
        from repro_torch.core.spatial import _batch_block_slice

        return _batch_block_slice(x, self.n, self.m)

    def merge_batch(self, t: torch.Tensor) -> torch.Tensor:
        """Batch blocks (n, m, b, H, W, C) -> global (n*m*b, H, W, C) in
        block order (the inverse of ``split_batch``)."""
        return t.reshape(-1, *t.shape[3:])


def make_tile_mesh(n: int, m: int, device: str | torch.device = "cuda") -> TileMesh:
    """Paper-native 2-D tile grid as a virtual mesh on ``device``."""
    if n < 1 or m < 1:
        raise ValueError(f"tile grid must be positive; got {n}x{m}")
    return TileMesh(n, m, resolve_device(device))


@dataclasses.dataclass(frozen=True)
class DistTileMesh(TileMesh):
    """The n x m tile grid spread over the ranks of ``group``: a rank grid
    ``ranks`` = (Rr, Rc) of equal blocks; this rank, at ``coord`` = (pr,
    pc) of it, holds tiles ``origin`` .. ``origin + block``.  Uniform
    partitions only (ragged ones are ROADMAP A.20.2)."""

    group: tdist.TileGroup
    ranks: tuple[int, int]
    coord: tuple[int, int]

    @property
    def block(self) -> tuple[int, int]:
        return self.n // self.ranks[0], self.m // self.ranks[1]

    @property
    def origin(self) -> tuple[int, int]:
        (bn, bm), (pr, pc) = self.block, self.coord
        return pr * bn, pc * bm

    def neighbour(self, dim: int, step: int) -> int | None:
        """The rank ``step`` blocks away along tile dimension ``dim``, or
        None past the grid's edge."""
        pos = list(self.coord)
        pos[dim] += step
        if not 0 <= pos[dim] < self.ranks[dim]:
            return None
        return pos[0] * self.ranks[1] + pos[1]

    def split(self, x, rows=None, cols=None):
        """Global (B, H, W, C) -> this rank's block of tiles (n/Rr, m/Rc, B,
        H/n, W/m, C)."""
        if rows is not None:
            raise ValueError("a non-uniform partition on ranks is ROADMAP A.20.2")
        (r0, c0), (bn, bm) = self.origin, self.block
        return super().split(x)[r0:r0 + bn, c0:c0 + bm]

    def merge(self, t, rows=None, cols=None):
        """Every rank's block of tiles -> global (B, n*h, m*w, C), gathered
        on every rank; not differentiated (an output)."""
        if rows is not None:
            raise ValueError("a non-uniform partition on ranks is ROADMAP A.20.2")
        with torch.no_grad():
            blocks = tdist.all_gather_blocks(self.group, t.detach())
        rows_of = [torch.cat(blocks[pr * self.ranks[1]:(pr + 1) * self.ranks[1]], dim=1)
                   for pr in range(self.ranks[0])]
        return super().merge(torch.cat(rows_of, dim=0))

    def split_batch(self, x):
        raise ValueError("a crossover (data-mode tail) on ranks is ROADMAP A.20.2")

    merge_batch = split_batch


def make_dist_tile_mesh(n: int, m: int, device: str | torch.device,
                        group: tdist.TileGroup) -> DistTileMesh:
    """The n x m tile grid over ``group``'s ranks (``dist.rank_grid``),
    this rank's block on ``device``, which must be the group's."""
    if n < 1 or m < 1:
        raise ValueError(f"tile grid must be positive; got {n}x{m}")
    dev = resolve_device(device)
    if dev.type != group.device.type or (dev.index is not None and dev != group.device):
        raise ValueError(f"mesh device {dev} is not the group's {group.device}")
    ranks = tdist.rank_grid(n, m, group.world)
    return DistTileMesh(n, m, group.device, group, ranks, divmod(group.rank, ranks[1]))


@dataclasses.dataclass(frozen=True)
class VirtualMesh:
    """Named mesh axes held on ONE device: ``shape`` maps each axis name to
    its size, in order, as a ``jax.sharding.Mesh``'s does.  Nothing is
    placed by it; a sharded operator keeps an axis's shards as a tensor
    dimension of that size."""

    axes: tuple[tuple[str, int], ...]
    device: torch.device

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)


def make_virtual_mesh(axes: dict[str, int], device: str | torch.device = "cuda") -> VirtualMesh:
    """A virtual mesh of the named axes (``{"data": 2, "model": 4}``) on
    ``device``."""
    if not axes or any(s < 1 for s in axes.values()):
        raise ValueError(f"mesh axes must be named with positive sizes; got {axes}")
    return VirtualMesh(tuple((str(a), int(s)) for a, s in axes.items()), resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device = "cuda") -> VirtualMesh:
    """The reference's production topology as a virtual mesh on ``device``:
    ``(data 16, model 16)``, one TPU v5e pod's 256 chips, or ``(pod 2, data
    16, model 16)`` across two pods.  The dry run prices a step per device
    of it; a step run under it keeps each axis's shards as a tensor
    dimension (the MoE dispatch's groups and expert shards)."""
    axes = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    return make_virtual_mesh(axes, device)


def make_local_mesh(axes=("data", "model"), device: str | torch.device = "cuda") -> VirtualMesh:
    """Whatever devices exist locally, as a ``(1, n_devices)`` mesh: one
    axis of size 1 and one of the cards of ``device``'s type (1 on the
    CPU)."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return make_virtual_mesh({axes[0]: 1, axes[1]: n}, dev)
