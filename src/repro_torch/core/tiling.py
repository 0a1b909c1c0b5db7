"""Tile/halo geometry for distributed CNN training (paper §4.2, eqs 1a-d / 2a-d).

The paper partitions feature maps (forward) and delta-gradient maps (backward)
into an N x M grid along height/width.  Each tile's convolution needs its core
region plus a *halo* of boundary data owned by neighbouring tiles.  When layers
are *grouped*, the halo at the group input is the recursively-grown dependent
region of the tile's output span across every layer in the group (eqs 1a-d for
the forward direction, 2a-d for backward).

Everything in this module is pure integer geometry - no tensors - so the
planner can feed static shapes to the virtual-mesh executor.  It is a copy of
``repro.core.tiling`` (the JAX package's geometry), kept here so the port
never imports the JAX package; ``tests/test_torch_tiling.py`` holds the two
copies equal.

Coordinate convention: a span is [x1, x2] *inclusive*, matching the paper's
(x1, y1)-(x2, y2) tile representation.  Layer ``l`` maps input spans to output
spans; ``dependent_region`` inverts that mapping (paper eq. 1), and
``forward_region`` applies it (paper eq. 2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence


# ---------------------------------------------------------------------------
# Layer descriptors
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    """Geometry-relevant description of a conv or pool layer.

    kernel: receptive field K (K x K filters).
    stride: stride S.
    pool:   True for pooling layers (geometry is identical; flag is kept so
            cost models can weight FLOPs differently).
    out_channels / in_channels: used only by the cost model.
    """

    kernel: int
    stride: int = 1
    in_channels: int = 0
    out_channels: int = 0
    pool: bool = False

    @property
    def half(self) -> int:
        return self.kernel // 2


@dataclasses.dataclass(frozen=True)
class Span:
    """Inclusive 1-D span [lo, hi]."""

    lo: int
    hi: int

    @property
    def size(self) -> int:
        return self.hi - self.lo + 1

    def clip(self, bound: int) -> "Span":
        return Span(max(self.lo, 0), min(self.hi, bound - 1))

    def shift(self, d: int) -> "Span":
        return Span(self.lo + d, self.hi + d)


@dataclasses.dataclass(frozen=True)
class TileBox:
    """2-D tile box: row span x col span (paper's (x1,y1)-(x2,y2))."""

    rows: Span
    cols: Span

    @property
    def shape(self) -> tuple[int, int]:
        return (self.rows.size, self.cols.size)


# ---------------------------------------------------------------------------
# Paper equations (1a-d): dependent region one layer backwards (forward pass)
# ---------------------------------------------------------------------------


def dependent_region_1d(span: Span, layer: ConvSpec) -> Span:
    """Input span of ``layer`` needed to produce output ``span``.

    Paper eq. (1a-d) for convolutional layer l-1 (SAME-padded convolution of
    stride S, kernel K):

        x1_{l-1} = x1_l * S - floor(K/2)
        x2_{l-1} = x2_l * S + floor(K/2) + (S - 1)
    """
    k2 = layer.half
    s = layer.stride
    return Span(span.lo * s - k2, span.hi * s + k2 + (s - 1))


def forward_region_1d(span: Span, layer: ConvSpec) -> Span:
    """Output span of ``layer`` computable from input ``span`` (paper eq. 2).

        x1_{l+1} = ceil((x1_l - floor(K/2)) / S)
        x2_{l+1} = floor((x2_l + floor(K/2)) / S)

    This is the exact inverse direction of eq. (1): the set of outputs whose
    dependent region lies fully inside ``span``.  The backward pass uses it to
    grow delta-map tile spans layer by layer.
    """
    k2 = layer.half
    s = layer.stride
    lo = math.ceil((span.lo - k2) / s)
    hi = math.floor((span.hi + k2) / s)
    return Span(lo, hi)


def dependent_region(box: TileBox, layer: ConvSpec) -> TileBox:
    return TileBox(dependent_region_1d(box.rows, layer), dependent_region_1d(box.cols, layer))


def forward_region(box: TileBox, layer: ConvSpec) -> TileBox:
    return TileBox(forward_region_1d(box.rows, layer), forward_region_1d(box.cols, layer))


# ---------------------------------------------------------------------------
# Grid partitioning
# ---------------------------------------------------------------------------


def partition_1d(extent: int, parts: int) -> list[Span]:
    """Split [0, extent) into ``parts`` near-equal inclusive spans."""
    if parts <= 0:
        raise ValueError(f"parts must be positive, got {parts}")
    if extent < parts:
        raise ValueError(f"cannot split extent {extent} into {parts} tiles")
    base, rem = divmod(extent, parts)
    spans = []
    lo = 0
    for i in range(parts):
        size = base + (1 if i < rem else 0)
        spans.append(Span(lo, lo + size - 1))
        lo += size
    return spans


def partition_grid(height: int, width: int, n: int, m: int) -> list[list[TileBox]]:
    """Paper Fig. 1: N x M grid-wise partition of an H x W map."""
    rows = partition_1d(height, n)
    cols = partition_1d(width, m)
    return [[TileBox(r, c) for c in cols] for r in rows]


# ---------------------------------------------------------------------------
# Explicit tile partitions: per-axis boundary arrays (DESIGN.md §8)
# ---------------------------------------------------------------------------


def even_bounds_1d(extent: int, parts: int) -> tuple[int, ...]:
    """Near-equal boundary offsets (0, b1, ..., extent) for ``parts`` tiles -
    the boundary-array form of ``partition_1d`` (ragged-even: the first
    ``extent % parts`` tiles are one row taller)."""
    spans = partition_1d(extent, parts)
    return tuple(s.lo for s in spans) + (extent,)


def spans_from_bounds(bounds: Sequence[int]) -> list[Span]:
    """Inclusive spans of a boundary array: tile i owns [b_i, b_{i+1})."""
    return [Span(lo, hi - 1) for lo, hi in zip(bounds, bounds[1:])]


def bounds_sizes(bounds: Sequence[int]) -> tuple[int, ...]:
    """Per-tile extents of a boundary array."""
    return tuple(hi - lo for lo, hi in zip(bounds, bounds[1:]))


def dedup_axis_shapes(sizes: Sequence[int]) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(branch_table, unique_sizes) for one axis of a ragged partition.

    ``branch_table[i]`` maps tile index i to the index of its extent among
    the *distinct* extents, in first-appearance order.  The shape-specialized
    executor (DESIGN.md §9) compiles ONE program per distinct tile shape and
    switches on this table, so a 2/62-style split compiles 2 row programs,
    not one per device.  Because boundaries divide by the cumulative stride
    at every layer (DESIGN.md §8), a tile's extent at every layer of a group
    is a pure function of its extent at the group start - the group-start
    size alone is a sufficient dedup key.
    """
    uniq: list[int] = []
    table: list[int] = []
    for s in sizes:
        if s not in uniq:
            uniq.append(s)
        table.append(uniq.index(s))
    return tuple(table), tuple(uniq)


@dataclasses.dataclass(frozen=True)
class TilePartition:
    """Explicit n x m grid partition of an H x W map: per-axis boundary
    offsets instead of the implicit uniform H/n x W/m split.

    ``row_bounds`` = (0, b1, ..., H): tile row i owns map rows
    [row_bounds[i], row_bounds[i+1]).  Uniform grids are the special case of
    equal boundary gaps; heterogeneous clusters size each tile proportional
    to its device's throughput (``core.grouping.cluster_partition``), and
    non-divisible extents get the ragged-even split (``TilePartition.even``).

    Boundaries are *map offsets at the layer the partition is expressed at*
    (the stack input, for planner-facing partitions); per-layer boundaries
    derive by ``push_bounds_1d`` through each layer's stride, which requires
    interior boundaries divisible by the cumulative stride - the invariant
    that keeps per-layer halo widths uniform across tiles (DESIGN.md §8).
    """

    row_bounds: tuple[int, ...]
    col_bounds: tuple[int, ...]

    def __post_init__(self):
        for name, b in (("row_bounds", self.row_bounds), ("col_bounds", self.col_bounds)):
            if len(b) < 2 or b[0] != 0:
                raise ValueError(f"{name} must start at 0 with >= 1 tile; got {b}")
            if any(hi <= lo for lo, hi in zip(b, b[1:])):
                raise ValueError(f"{name} must be strictly increasing; got {b}")

    @property
    def n(self) -> int:
        return len(self.row_bounds) - 1

    @property
    def m(self) -> int:
        return len(self.col_bounds) - 1

    @property
    def extent(self) -> tuple[int, int]:
        return (self.row_bounds[-1], self.col_bounds[-1])

    @property
    def row_sizes(self) -> tuple[int, ...]:
        return bounds_sizes(self.row_bounds)

    @property
    def col_sizes(self) -> tuple[int, ...]:
        return bounds_sizes(self.col_bounds)

    @property
    def is_uniform(self) -> bool:
        """Equal-boundary special case: every tile the same shape (the
        pre-refactor uniform grid; executors take the legacy zero-padding-
        free path)."""
        return len(set(self.row_sizes)) == 1 and len(set(self.col_sizes)) == 1

    @staticmethod
    def even(h: int, w: int, n: int, m: int) -> "TilePartition":
        """Near-equal split (uniform when n | h and m | w, ragged-even
        otherwise) - the boundary-array form of the old implicit grid."""
        return TilePartition(even_bounds_1d(h, n), even_bounds_1d(w, m))

    @staticmethod
    def from_sizes(row_sizes: Sequence[int], col_sizes: Sequence[int]) -> "TilePartition":
        rb, cb = [0], [0]
        for s in row_sizes:
            rb.append(rb[-1] + s)
        for s in col_sizes:
            cb.append(cb[-1] + s)
        return TilePartition(tuple(rb), tuple(cb))

    def row_span(self, i: int) -> Span:
        return Span(self.row_bounds[i], self.row_bounds[i + 1] - 1)

    def col_span(self, j: int) -> Span:
        return Span(self.col_bounds[j], self.col_bounds[j + 1] - 1)

    def tile_box(self, i: int, j: int) -> TileBox:
        return TileBox(self.row_span(i), self.col_span(j))


def push_bounds_1d(bounds: Sequence[int], stride: int, out_extent: int) -> tuple[int, ...]:
    """Boundary array at a layer *output* from its input boundary array.

    Tile ownership maps through a stride-S layer as ``r_i = b_i / S``
    (output row r depends on input rows starting at r*S - P, so input
    boundary b owned by tile i puts output boundary b/S at the same tile).
    Interior boundaries must divide by the stride - otherwise a tile's halo
    width would differ from its neighbours', which a single SPMD program
    cannot express; `even`/`cluster` partitions are stride-aligned by
    construction (built by pulling an output-level split back through the
    strides)."""
    out = [0]
    for b in bounds[1:-1]:
        if b % stride:
            raise ValueError(
                f"tile boundary {b} not aligned to stride {stride}; partition "
                "boundaries must divide by the cumulative stride at each layer"
            )
        out.append(b // stride)
    out.append(out_extent)
    if any(hi <= lo for lo, hi in zip(out, out[1:])):
        raise ValueError(
            f"partition leaves an empty tile at a stride-{stride} layer "
            f"(output bounds {out}); use a coarser grid or different boundaries"
        )
    return tuple(out)


def pull_bounds_1d(out_bounds: Sequence[int], stride: int, in_extent: int) -> tuple[int, ...]:
    """Boundary array at a layer *input* from its output boundary array
    (inverse of ``push_bounds_1d``; always stride-aligned by construction)."""
    bounds = (0,) + tuple(r * stride for r in out_bounds[1:-1]) + (in_extent,)
    if any(hi <= lo for lo, hi in zip(bounds, bounds[1:])):
        raise ValueError(
            f"pull-back through stride {stride} leaves an empty tile "
            f"(bounds {bounds})"
        )
    return bounds


def propagate_bounds(
    bounds: Sequence[int], strides: Sequence[int], extents: Sequence[int]
) -> list[tuple[int, ...]]:
    """Per-layer boundary arrays 0..len(strides) from an input-level array.

    ``extents[l]`` is the map extent at the input of layer l (entry
    len(strides) = the final output); validates stride alignment and tile
    non-emptiness at every layer."""
    if bounds[-1] != extents[0]:
        raise ValueError(
            f"partition extent {bounds[-1]} does not match map extent {extents[0]}"
        )
    out = [tuple(bounds)]
    for l, s in enumerate(strides):
        out.append(push_bounds_1d(out[-1], s, extents[l + 1]))
    return out


def even_bounds_from_output(
    strides: Sequence[int], extents: Sequence[int], parts: int
) -> list[tuple[int, ...]]:
    """Stride-aligned ragged-even boundary arrays for every layer, built by
    near-evenly splitting the *final* extent and pulling the boundaries back
    through the strides (b_l = r_{l+1} * S_l).  For grid-divisible extents
    this is exactly the uniform i*H/n grid at every layer."""
    out = [even_bounds_1d(extents[-1], parts)]
    for l in range(len(strides) - 1, -1, -1):
        out.append(pull_bounds_1d(out[-1], strides[l], extents[l]))
    out.reverse()
    return out


def derive_axis_bounds(
    bounds0: Sequence[int] | None,
    strides: Sequence[int],
    extents: Sequence[int],
    parts: int,
) -> list[tuple[int, ...]]:
    """Per-layer boundary arrays for one axis: propagate an explicit
    input-level boundary array through the strides, or build the
    stride-aligned ragged-even default.  The single derivation the planner
    (``fusion.build_stack_plan``) and the cost model
    (``grouping._layer_tiles``) both use, so the executor's geometry and
    the modeled cost/memory can never desynchronise."""
    if bounds0 is None:
        return even_bounds_from_output(strides, extents, parts)
    return propagate_bounds(bounds0, strides, extents)


# ---------------------------------------------------------------------------
# Layer grouping
# ---------------------------------------------------------------------------

#: Partition modes a group can run under (DESIGN.md §7, §11).  ``"spatial"``
#: is the paper's tiling/fusing regime: the feature map is sharded over the
#: tile grid and group inputs exchange halos.  ``"data"`` replicates the
#: full feature map per device and shards the *batch* over the same mesh
#: axes instead - the regime that wins for the weight-dominated tail of a
#: CNN, reached through one reshard at the spatial->data crossover.
#: ``"pipeline"`` assigns the group itself to a disjoint *device subset*
#: (a stage) and streams microbatches through consecutive stages - the
#: inter-layer partitioning axis (DESIGN.md §11): each pipeline group is
#: one stage, activations/cotangents ppermute between adjacent stage
#: subsets, and per-device memory holds only the stage's own layers.
MODES = ("spatial", "data", "pipeline")


@dataclasses.dataclass(frozen=True)
class Group:
    """Group (s, e): layers s..e inclusive; halo sync happens at the input of
    layer ``s`` only (paper §4.2 tuple (s, e) convention, adapted to
    inclusive layer indices).

    ``mode`` selects the group's partitioning: ``"spatial"`` (tile grid +
    halos, the default and the paper's front-of-network regime), ``"data"``
    (batch split over the same devices, full maps, no halos) or
    ``"pipeline"`` (the group is one pipeline *stage* on its own device
    subset, DESIGN.md §11).  A valid profile is a spatial prefix followed
    by either a data suffix or a pipeline suffix - one mode transition at
    most (``validate_profile``)."""

    start: int
    end: int
    mode: str = "spatial"

    @property
    def layers(self) -> range:
        return range(self.start, self.end + 1)


def validate_profile(groups: Sequence[Group], n_layers: int) -> None:
    """A grouping profile must tile 0..n_layers-1 contiguously, with valid
    per-group modes forming a spatial prefix + (data | pipeline) suffix: at
    most one mode transition, and data/pipeline groups never mix.  A
    data->spatial or pipeline->anything-else transition would need a second
    reshard the executor deliberately does not implement, and a data group
    before a pipeline group would leave the batch sharded over all devices
    while stage 0 expects whole-map microbatch blocks."""
    if not groups:
        raise ValueError("empty grouping profile")
    expect = 0
    seen_data = seen_pipe = False
    for g in groups:
        if g.start != expect or g.end < g.start:
            raise ValueError(f"profile not contiguous at group {g}")
        if g.mode not in MODES:
            raise ValueError(f"group {g} mode must be one of {MODES}")
        if g.mode == "data":
            if seen_pipe:
                raise ValueError(
                    f"data group {g} follows a pipeline group; a plan takes "
                    "either a data tail or a pipeline tail, never both "
                    "(spatial prefix -> one non-spatial suffix)"
                )
            seen_data = True
        elif g.mode == "pipeline":
            if seen_data:
                raise ValueError(
                    f"pipeline group {g} follows a data group; pipeline "
                    "stages must directly follow the spatial prefix - a "
                    "plan takes either a data tail or a pipeline tail, "
                    "never both"
                )
            seen_pipe = True
        elif seen_data or seen_pipe:
            raise ValueError(
                f"spatial group {g} follows a {'data' if seen_data else 'pipeline'} "
                "group; modes must be a spatial prefix + one non-spatial "
                "suffix (single transition)"
            )
        expect = g.end + 1
    if expect != n_layers:
        raise ValueError(f"profile covers {expect} layers, model has {n_layers}")


def crossover_of(groups: Sequence[Group]) -> int | None:
    """First data-mode *layer* index of a profile, or None when the profile
    is all-spatial.  This is where the executor reshards (DESIGN.md §7)."""
    for g in groups:
        if g.mode == "data":
            return g.start
    return None


def pipeline_first_of(groups: Sequence[Group]) -> int | None:
    """First pipeline-mode *layer* index, or None when no pipeline tail
    exists.  This is where the executor reshards the tile grid into
    stage-0 microbatch blocks (DESIGN.md §11)."""
    for g in groups:
        if g.mode == "pipeline":
            return g.start
    return None


def apply_crossover(groups: Sequence[Group], crossover: int | None) -> list[Group]:
    """Assign modes to a grouping profile from a crossover layer index:
    groups before ``crossover`` become spatial, groups from it onwards
    data.  ``crossover`` must land on a group boundary (the reshard is a
    group-input event, like a halo exchange); ``None`` means all-spatial."""
    if crossover is None:
        return [dataclasses.replace(g, mode="spatial") for g in groups]
    out = []
    for g in groups:
        if g.start < crossover <= g.end:
            raise ValueError(
                f"crossover layer {crossover} falls inside group "
                f"({g.start}, {g.end}); it must align with a group boundary"
            )
        out.append(
            dataclasses.replace(g, mode="data" if g.start >= crossover else "spatial")
        )
    return out


def no_grouping(n_layers: int) -> list[Group]:
    """Sync every layer (paper's Pi-optimal profile)."""
    return [Group(i, i) for i in range(n_layers)]


def single_group(n_layers: int) -> list[Group]:
    """One group for the whole network (max redundant compute, min syncs)."""
    return [Group(0, n_layers - 1)]


def uniform_grouping(n_layers: int, group_size: int) -> list[Group]:
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    groups = []
    s = 0
    while s < n_layers:
        e = min(s + group_size - 1, n_layers - 1)
        groups.append(Group(s, e))
        s = e + 1
    return groups


# ---------------------------------------------------------------------------
# Group halo growth (recursive application of eq. 1 across a group)
# ---------------------------------------------------------------------------


def group_input_region_1d(out_span: Span, layers: Sequence[ConvSpec]) -> Span:
    """Dependent input span at the *group input* for an output span at the
    group output, by recursing eq. (1) backwards through ``layers``
    (ordered first..last)."""
    span = out_span
    for layer in reversed(layers):
        span = dependent_region_1d(span, layer)
    return span


def group_halo_width(layers: Sequence[ConvSpec]) -> int:
    """Halo width (per side, at unit stride product) the group input needs
    beyond the core tile.  Equals the cumulative receptive-field growth."""
    span = Span(0, 0)
    for layer in reversed(list(layers)):
        span = dependent_region_1d(span, layer)
    return -span.lo


def cumulative_stride(layers: Sequence[ConvSpec]) -> int:
    s = 1
    for layer in layers:
        s *= layer.stride
    return s


# ---------------------------------------------------------------------------
# Full tiling plan: per-group, per-layer spans for every tile
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """Static geometry of one layer inside one group for one tile.

    in_box / out_box: spans (possibly exceeding map bounds before clipping)
    of the data this tile holds at the layer input/output.  ``pad``: how much
    of the in_box hangs off each map edge (top, bottom, left, right) and must
    be zero-filled (SAME-conv boundary semantics).
    """

    layer_index: int
    in_box: TileBox
    out_box: TileBox
    pad: tuple[int, int, int, int]


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    group: Group
    # Span (per tile) of the data gathered at the group input, i.e. core tile
    # + halo.  Unclipped; pad gives the off-edge zero fill.
    gather_box: TileBox
    pad: tuple[int, int, int, int]
    layers: tuple[LayerPlan, ...]


@dataclasses.dataclass(frozen=True)
class TilePlan:
    tile: tuple[int, int]
    groups: tuple[GroupPlan, ...]


@dataclasses.dataclass(frozen=True)
class TilingPlan:
    """Complete forward-pass geometry for an (n x m) tiling of a conv stack
    under a grouping profile.  Backward geometry mirrors it (eq. 2) and is
    derived by AD at runtime; `bwd_halo_widths` records the analytic widths
    for the cost model.

    ``row_bounds`` / ``col_bounds`` (one boundary array per layer extent,
    DESIGN.md §8) record the explicit tile partition; ``None`` entries mean
    the legacy per-extent near-even split."""

    n: int
    m: int
    input_hw: tuple[int, int]
    layer_hw: tuple[tuple[int, int], ...]  # map extent at each layer input
    groups: tuple[Group, ...]
    tiles: tuple[tuple[TilePlan, ...], ...]
    row_bounds: tuple[tuple[int, ...], ...] | None = None
    col_bounds: tuple[tuple[int, ...], ...] | None = None

    def tile_plan(self, i: int, j: int) -> TilePlan:
        return self.tiles[i][j]

    def extent_spans(self, extent_index: int) -> tuple[list[Span], list[Span]]:
        """(row spans, col spans) of the partition at a layer extent."""
        if self.row_bounds is not None:
            return (
                spans_from_bounds(self.row_bounds[extent_index]),
                spans_from_bounds(self.col_bounds[extent_index]),
            )
        h, w = self.layer_hw[extent_index]
        return partition_1d(h, self.n), partition_1d(w, self.m)


def _layer_extents(input_hw: tuple[int, int], layers: Sequence[ConvSpec]) -> list[tuple[int, int]]:
    """Map extents at the input of each layer (and the final output)."""
    h, w = input_hw
    ext = [(h, w)]
    for sp in layers:
        h = -(-h // sp.stride)
        w = -(-w // sp.stride)
        ext.append((h, w))
    return ext


def build_tiling_plan(
    input_hw: tuple[int, int],
    layers: Sequence[ConvSpec],
    n: int,
    m: int,
    groups: Sequence[Group] | None = None,
    partition: TilePartition | None = None,
) -> TilingPlan:
    """Construct the complete forward tiling plan.

    Per paper §4.2: for each group (s, e), the output of layer e is
    partitioned among tiles, then eq. (1) recursively yields each tile's
    dependent region at every intermediate layer down to the group input,
    which defines the gather (core+halo) box.

    ``partition``: explicit input-level boundary arrays (DESIGN.md §8);
    per-layer boundaries derive by pushing them through the strides.  None
    keeps the legacy behaviour (each extent split near-evenly on its own).
    """
    layers = list(layers)
    n_layers = len(layers)
    groups = list(groups) if groups is not None else no_grouping(n_layers)
    validate_profile(groups, n_layers)
    extents = _layer_extents(input_hw, layers)

    row_bounds = col_bounds = None
    if partition is not None:
        if (partition.n, partition.m) != (n, m):
            raise ValueError(
                f"partition grid {(partition.n, partition.m)} != plan grid {(n, m)}"
            )
        strides = [sp.stride for sp in layers]
        row_bounds = tuple(
            propagate_bounds(partition.row_bounds, strides, [e[0] for e in extents])
        )
        col_bounds = tuple(
            propagate_bounds(partition.col_bounds, strides, [e[1] for e in extents])
        )

    tiles: list[list[TilePlan]] = [[None] * m for _ in range(n)]  # type: ignore
    for i in range(n):
        for j in range(m):
            gplans = []
            for g in groups:
                out_h, out_w = extents[g.end + 1]
                if row_bounds is not None:
                    out_rows = spans_from_bounds(row_bounds[g.end + 1])[i]
                    out_cols = spans_from_bounds(col_bounds[g.end + 1])[j]
                else:
                    out_rows = partition_1d(out_h, n)[i]
                    out_cols = partition_1d(out_w, m)[j]
                # Recurse eq. (1) from group output back to group input,
                # recording the (unclipped) in/out boxes of each layer.
                boxes = [TileBox(out_rows, out_cols)]
                for l in range(g.end, g.start - 1, -1):
                    boxes.append(dependent_region(boxes[-1], layers[l]))
                boxes.reverse()  # boxes[k] = input box of layer (s + k)
                lplans = []
                for k, l in enumerate(g.layers):
                    ih, iw = extents[l]
                    ib, ob = boxes[k], boxes[k + 1]
                    pad = (
                        max(0, -ib.rows.lo),
                        max(0, ib.rows.hi - (ih - 1)),
                        max(0, -ib.cols.lo),
                        max(0, ib.cols.hi - (iw - 1)),
                    )
                    lplans.append(LayerPlan(l, ib, ob, pad))
                gh, gw = extents[g.start]
                gb = boxes[0]
                gpad = (
                    max(0, -gb.rows.lo),
                    max(0, gb.rows.hi - (gh - 1)),
                    max(0, -gb.cols.lo),
                    max(0, gb.cols.hi - (gw - 1)),
                )
                gplans.append(GroupPlan(g, gb, gpad, tuple(lplans)))
            tiles[i][j] = TilePlan((i, j), tuple(gplans))

    return TilingPlan(
        n=n,
        m=m,
        input_hw=tuple(input_hw),
        layer_hw=tuple(extents),
        groups=tuple(groups),
        tiles=tuple(tuple(r) for r in tiles),
        row_bounds=row_bounds,
        col_bounds=col_bounds,
    )


# ---------------------------------------------------------------------------
# Derived quantities for the cost model / memory accounting
# ---------------------------------------------------------------------------


def halo_bytes_per_group(plan: TilingPlan, layers: Sequence[ConvSpec], dtype_bytes: int = 4) -> list[int]:
    """Total boundary bytes exchanged at each group input across all tiles
    (forward pass; backward is symmetrical, the paper notes, so x2 for a
    training step)."""
    layers = list(layers)
    out = []
    for gi, g in enumerate(plan.groups):
        total = 0
        ih, iw = plan.layer_hw[g.start]
        ch = layers[g.start].in_channels
        in_rows, in_cols = plan.extent_spans(g.start)
        for i in range(plan.n):
            for j in range(plan.m):
                gp = plan.tiles[i][j].groups[gi]
                core_rows = in_rows[i]
                core_cols = in_cols[j]
                gb = gp.gather_box
                clipped = TileBox(gb.rows.clip(ih), gb.cols.clip(iw))
                halo_elems = (
                    clipped.rows.size * clipped.cols.size
                    - core_rows.size * core_cols.size
                )
                total += max(0, halo_elems) * max(ch, 1) * dtype_bytes
        out.append(total)
    return out


def redundant_flops(plan: TilingPlan, layers: Sequence[ConvSpec]) -> int:
    """Extra MACs computed because grouped tiles redo halo regions locally."""
    layers = list(layers)
    total = 0
    for gi, g in enumerate(plan.groups):
        for l in g.layers:
            sp = layers[l]
            oh, ow = plan.layer_hw[l + 1]
            per_out = 2 * sp.kernel * sp.kernel * max(sp.in_channels, 1) * max(sp.out_channels, 1)
            tiled_outputs = 0
            for i in range(plan.n):
                for j in range(plan.m):
                    ob = plan.tiles[i][j].groups[gi].layers[l - g.start].out_box
                    clipped = TileBox(ob.rows.clip(oh), ob.cols.clip(ow))
                    tiled_outputs += clipped.rows.size * clipped.cols.size
            total += per_out * max(0, tiled_outputs - oh * ow)
    return total


def peak_tile_activation_elems(plan: TilingPlan, layers: Sequence[ConvSpec]) -> int:
    """Peak per-tile activation footprint (elements), the paper's Fig. 6
    memory metric: max over layers of (gathered input + produced output)."""
    layers = list(layers)
    peak = 0
    for row in plan.tiles:
        for tp in row:
            for gp in tp.groups:
                for lp in gp.layers:
                    sp = layers[lp.layer_index]
                    cin = max(sp.in_channels, 1)
                    cout = max(sp.out_channels, 1)
                    elems = lp.in_box.shape[0] * lp.in_box.shape[1] * cin
                    elems += lp.out_box.shape[0] * lp.out_box.shape[1] * cout
                    peak = max(peak, elems)
    return peak
