"""Fused, grouped execution stacks (paper §4.2) on the virtual tile mesh.

The port of ``repro/core/fusion.py``: the planner for
explicit, absent or cost-model-chosen groupings (``groups="auto"`` over a
hardware profile or cluster, ``core/grouping.py``), spatial->data
crossovers (``crossover=``, DESIGN.md §7), pipeline tails (``pipeline=``,
DESIGN.md §11) and explicit or cluster-balanced tile partitions
(``partition=``, DESIGN.md §8), the executor under the sync and overlap
schedules (DESIGN.md §5) and, for non-uniform partitions, the
shape-specialised and padded ragged executors (``ragged_exec=``, DESIGN.md
§8-9), the pipeline tick executor (``_make_pipeline_local``), the forward
/ inference wrappers that split a global batch into tiles and assemble the
global output, and the training entry points - the tiled loss and the
deferred-aggregation gradient step.  Every plan runs under a wire codec
(``wire_codec=``, DESIGN.md §12): forward strips compressed stateless, the
deferred step's backward strips under error feedback carried across the
microbatches of one batch.  A group exchanges halos once at its input; inside it every
tile carries a recursively grown halo and recomputes boundary regions
redundantly.  Data-mode groups run on batch blocks of full maps.

The forward, the loss, the deferred step and the inference forward also run
on ranks (``launch/mesh.py:DistTileMesh``, ``parallel/dist.py``): each rank
runs any plan - either schedule, a crossover, any codec, a ragged partition
under either executor, a pipeline tail - on its block of tiles, the
exchanges, reshards, hand-offs and BN sums cross ranks, and the deferred
step all-reduces the accumulated gradients once at batch end.

Halo-width algebra (from the eq. 1 recursion, DESIGN.md §2):

    group_halo_lo = sum_l P_l * prod_{l'<l in group} S_l'
    group_halo_hi = sum_l (K_l - S_l - P_l) * prod_{l'<l in group} S_l'

and the remaining halo after layer l shrinks as (h - P_l) / S_l.
"""
from __future__ import annotations

import dataclasses
import logging
import re
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.backend import get_conv_backend
from repro_torch.core.grouping import (
    ClusterSpec,
    HardwareProfile,
    PI3_PROFILE,
    PIPELINE_MICROBATCHES,
    PROFILES,
    check_crossover_arg,
    check_pipeline_arg,
    cluster_manifest,
    cluster_partition,
    feasible_stage_counts,
    optimize_grouping,
    parse_cluster_spec,
    profile_cost,
    score_profile,
)
from repro_torch.core.halo import (
    GRID_DIMS,
    EFBag,
    WireCtx,
    _move,
    _move_start,
    _switch_by_size,
    halo_exchange_2d,
    halo_exchange_2d_ragged,
    halo_exchange_2d_spec,
)
from repro_torch.core.spatial import (
    LayerDef,
    apply_group_lead_overlap,
    apply_layer_data,
    apply_layer_local,
    apply_layer_local_ragged,
    apply_layer_local_spec,
    reshard_spatial_to_data,
    reshard_spatial_to_data_ragged,
    stack_reference,
)
from repro_torch.core.tiling import (
    Group,
    TilePartition,
    apply_crossover,
    bounds_sizes,
    crossover_of,
    derive_axis_bounds,
    no_grouping,
    pipeline_first_of,
    validate_profile,
)
from repro_torch.launch.mesh import DistTileMesh, TileMesh, local_table, plan_constant
from repro_torch.optim.compression import ef_encode, get_codec
from repro_torch.parallel.dist import (
    active_tile_mesh,
    all_gather_axis,
    all_reduce_,
    replicated,
    tile_mesh_ctx,
)


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """Static geometry for an (n x m)-tiled, grouped conv stack.

    The fields are the reference's, so ``plan_manifest`` describes a port
    plan exactly as it describes the JAX plan with the same knobs.
    ``shard_hw`` is the largest tile per layer; past a crossover or a
    pipeline entry the per-layer tile extents are the full maps.  A pipeline
    tail (DESIGN.md §11) gives each pipeline-mode group - a *stage* - its
    own contiguous range of flat tiles (``r = i*m + j``): ``stages[s] =
    (lo, hi)``, equal-sized and row-aligned, so the hand-off between stages
    is one axis-aligned shift of the tile grid."""

    layers: tuple[LayerDef, ...]
    groups: tuple[Group, ...]
    n: int
    m: int
    input_hw: tuple[int, int]
    map_hw: tuple[tuple[int, int], ...]          # extent at each layer input; [-1] = output
    shard_hw: tuple[tuple[int, int], ...]        # shard extent per layer input
    group_halos: tuple[tuple[int, int, int, int], ...]   # (top,bot,left,right) @ group input
    rem_halos: tuple[tuple[int, int, int, int], ...]     # remaining halo after each layer
    group_of_layer: tuple[int, ...]
    backend: str = "torch"                       # conv compute path (core.backend)
    schedule: str = "sync"
    block_oh: int | None = None                  # conv output-row block (None = auto)
    crossover: int | None = None                 # first data-mode layer (None = all spatial)
    partition: TilePartition | None = None       # input-level tile boundaries
    tile_rows: tuple[tuple[int, ...], ...] = ()  # per layer input: per-tile-row extents
    tile_cols: tuple[tuple[int, ...], ...] = ()
    ragged_exec: str = "spec"
    stages: tuple[tuple[int, int], ...] = ()
    wire_codec: str = "none"                     # per-tile strip codec (DESIGN.md §12)
    inference: bool = False                      # forward-only serve plan (DESIGN.md §13)

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def inference_twin(self) -> "StackPlan":
        """The forward-only serving twin: same geometry and compute knobs,
        BN from frozen statistics."""
        if self.stages:
            raise ValueError(
                "pipeline plans have no inference twin: serve steps need a "
                "single-shot forward layout; replan without the pipeline tail"
            )
        return dataclasses.replace(self, inference=True)

    def out_hw(self) -> tuple[int, int]:
        return self.map_hw[-1]

    @property
    def pipeline_first(self) -> int | None:
        """First pipeline-mode layer index (None = no pipeline tail)."""
        return pipeline_first_of(self.groups)

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def spatial_last(self) -> int:
        """Deepest spatially tiled layer-input index: the first non-spatial
        layer, or the stack output for all-spatial plans."""
        if self.crossover is not None:
            return self.crossover
        pf = self.pipeline_first
        return self.n_layers if pf is None else pf

    @property
    def is_uniform(self) -> bool:
        """True when every tile has the same shape at every spatially tiled
        layer (the full-map extents past them are equal by construction)."""
        if not self.tile_rows:
            return True
        return all(
            len(set(self.tile_rows[l])) == 1 and len(set(self.tile_cols[l])) == 1
            for l in range(self.spatial_last + 1)
        )


def resolve_hw_profile(hw: HardwareProfile | ClusterSpec | str | None):
    """Profile object from a profile, a ClusterSpec, a registered name, or
    None (Pi default)."""
    if hw is None:
        return PI3_PROFILE
    if isinstance(hw, str):
        try:
            return PROFILES[hw]
        except KeyError:
            raise KeyError(
                f"unknown hardware profile {hw!r}; available: {sorted(PROFILES)}"
            ) from None
    return hw


def _resolve_hw(hw, n: int, m: int):
    """Like ``resolve_hw_profile`` but also accepts cluster spec strings
    ("pi3x3+jetson") - resolvable only here, where the grid is known.
    Strings that *look* like cluster specs ('+'-joined or counted parts)
    surface parse_cluster_spec's own error (device-count mismatch, unknown
    device) instead of the misleading unknown-profile KeyError."""
    if isinstance(hw, str) and hw not in PROFILES:
        if "+" in hw or re.search(r"x\d+$", hw):
            return parse_cluster_spec(hw, n, m)
    return resolve_hw_profile(hw)


def _resolve_crossover(
    input_hw,
    layers,
    groups: tuple[Group, ...],
    crossover: int | str | None,
    n: int,
    m: int,
    hw,
    batch: int,
    schedule: str,
    mem_limit: float | None = None,
    partition: TilePartition | None = None,
    wire_codec: str = "none",
) -> tuple[Group, ...]:
    """Assign partition modes to an *explicit* grouping profile.

    ``crossover=None`` keeps the modes the groups already carry; an int
    forces the spatial->data transition at that layer (must align with a
    group boundary; L = all-spatial, same as the optimizer's convention);
    ``"auto"`` scores every group boundary (and "none") through the same
    ``grouping.score_profile`` routine the joint optimizer uses (cost +
    mem_limit feasibility) and keeps the cheapest."""
    if crossover is None:
        return groups
    check_crossover_arg(crossover, len(layers))
    if isinstance(crossover, int):
        return tuple(apply_crossover(groups, crossover))
    best = None
    for c in [None] + [g.start for g in groups]:
        cand = tuple(apply_crossover(groups, c))
        cost = score_profile(
            input_hw, layers, cand, n, m, hw, batch, schedule, mem_limit,
            partition=partition, wire_codec=wire_codec,
        )
        if cost is None:
            continue
        if best is None or cost < best[0]:
            best = (cost, cand)
    if best is None:
        raise ValueError(
            f"no crossover candidate of this profile fits mem_limit={mem_limit}"
        )
    return best[1]


def _resolve_auto_schedule(
    input_hw, layers, groups, n, m, hw, batch, partition, device=None
) -> str:
    """Resolve ``schedule="auto"`` to a concrete schedule (DESIGN.md §5).

    Overlap pays only when (a) the device the plan runs on can run
    collectives concurrently with compute (``compat.overlap_supported``: a
    card can, the host CPU runs them inline) and (b) the cost model
    predicts a non-trivial hidden term.  ``device`` None means the default
    device: the card when one is present.  Heterogeneous clusters stay on
    sync: the overlap interior/boundary split applies only to uniform
    groups."""
    from repro_torch import compat

    if isinstance(hw, ClusterSpec) or not compat.overlap_supported(device):
        return "sync"
    cand = (
        tuple(groups)
        if groups is not None and not isinstance(groups, str)
        else tuple(no_grouping(len(layers)))
    )
    cost = profile_cost(
        input_hw, tuple(layers), cand, n, m, resolve_hw_profile(hw),
        batch, "overlap", partition=partition,
    )
    return "overlap" if cost["hidden"] > 0.01 * cost["total"] else "sync"


def build_stack_plan(
    input_hw: tuple[int, int],
    layers: Sequence[LayerDef],
    n: int,
    m: int,
    groups: Sequence[Group] | str | None = None,
    *,
    backend: str = "torch",
    schedule: str = "sync",
    block_oh: int | None = None,
    hw: HardwareProfile | ClusterSpec | str | None = None,
    batch: int = 1,
    crossover: int | str | None = None,
    mem_limit: float | None = None,
    partition: TilePartition | None = None,
    ragged_exec: str = "spec",
    pipeline: int | str | None = None,
    microbatches: int = PIPELINE_MICROBATCHES,
    wire_codec: str = "none",
    inference: bool = False,
    device: str | torch.device | None = None,
) -> StackPlan:
    """Planner: all static geometry + compute-path choices for a tiled stack.

    groups: an explicit profile, None (= sync every layer), or ``"auto"`` -
    the DP cost-model optimizer (``core/grouping.py``) against ``hw`` (a
    HardwareProfile, a registered profile name, a ClusterSpec or a cluster
    spec string like ``"pi3x4"``; None = the Pi default) at batch size
    ``batch``, with ``microbatches`` for the pipeline bubble model and
    ``mem_limit`` (bytes per device) bounding the modelled working set.
    backend: registered conv compute path ("torch" | "cuda").  schedule:
    "sync" (eager halo exchange), "overlap" (packed exchange and the
    interior/boundary split of every group lead with a halo, DESIGN.md §5),
    or "auto" (overlap only when ``device`` can hide collectives and the
    modelled hidden term is non-trivial; ``device`` None = the default
    device); it flows into the cost model under ``groups="auto"``.
    crossover (DESIGN.md §7): where the plan switches from spatial tiling to
    data parallelism - None keeps the modes the groups carry, an int pins
    the first data-mode layer (on a group boundary), ``"auto"`` lets the
    cost model choose, jointly with the grouping under ``groups="auto"``,
    else among the given profile's boundaries.  Data-mode layers hold full
    maps, so only the spatial prefix must divide over the grid.
    partition (DESIGN.md §8): explicit input-level ``TilePartition`` boundary
    arrays.  None derives one: the FLOPs-balanced partition when ``hw`` is a
    ClusterSpec (or a cluster spec string like ``"pi3x3+jetson"``), else the
    stride-aligned ragged-even split, which is the uniform grid whenever the
    extents divide.  Non-uniform partitions run the shape-specialised
    executor (``ragged_exec="spec"``, DESIGN.md §9: one conv per distinct
    tile shape over the true extents) or the padded one (``"padded"``,
    DESIGN.md §8: one conv over every tile padded to the largest); either
    runs the sync exchange, whatever ``schedule`` says.
    pipeline (DESIGN.md §11): None keeps pipeline tails out of the search;
    ``"auto"`` lets the grouping DP weigh pipeline tails (entry layer x
    stage count, bubble and transfer terms) against the other candidates;
    an int forces that many stages.  Planner-assigned only: it needs
    ``groups="auto"`` (an explicit profile may carry pipeline-mode groups
    itself).  Stages hold no BN layer, need the sync schedule and a uniform
    partition of the spatial prefix.  ``microbatches`` is the M the bubble
    (S-1)/(S-1+M) is modelled with; the executor's M is the grad step's.
    inference: plan a forward-only serve step (BN from frozen statistics);
    never with a pipeline tail.  wire_codec (DESIGN.md §12): "none", "int8"
    or "topk:<k>" - every exchange, reshard and pipeline hand-off ships its
    strips through the codec, and the cost model prices the wire under it;
    a bad spec fails here."""
    get_conv_backend(backend)   # fail fast on unknown backends
    if schedule not in ("sync", "overlap", "auto"):
        raise ValueError(f"schedule must be 'sync', 'overlap', or 'auto'; got {schedule!r}")
    if ragged_exec not in ("spec", "padded"):
        raise ValueError(f"ragged_exec must be 'spec' or 'padded'; got {ragged_exec!r}")
    if block_oh is not None and block_oh < 1:
        raise ValueError(f"block_oh must be a positive int or None; got {block_oh!r}")
    get_codec(wire_codec)   # fail fast on bad codec specs (none | int8 | topk:<k>)
    layers = tuple(layers)
    if inference and pipeline is not None:
        raise ValueError(
            "inference plans cannot carry a pipeline tail: a serve step "
            "needs a single-shot forward layout, but pipeline outputs live "
            "on the last stage's devices only; plan with pipeline=None"
        )
    check_pipeline_arg(pipeline, n, m, len(layers))
    if pipeline is not None:
        if schedule == "overlap":
            raise ValueError(
                "schedule='overlap' cannot combine with a pipeline tail: the "
                "interior/boundary split assumes every device runs the same "
                "halo exchange, but pipeline stages run disjoint layer "
                "programs; use schedule='sync' (or 'auto', which resolves "
                "to sync for pipeline plans)"
            )
        if groups is None or not isinstance(groups, str):
            raise ValueError(
                "pipeline tails are planner-assigned: use groups='auto' "
                "with pipeline=..., or pass an explicit profile that "
                "already carries pipeline-mode groups (e.g. from a plan "
                "manifest) without the pipeline kwarg"
            )
        schedule = "sync" if schedule == "auto" else schedule
    if isinstance(groups, str) and groups != "auto":
        raise ValueError(f"groups must be a profile, None, or 'auto'; got {groups!r}")
    hw = _resolve_hw(hw, n, m) if hw is not None else None
    if schedule == "auto":
        schedule = _resolve_auto_schedule(
            input_hw, layers, groups, n, m, hw, batch, partition, device
        )
    if isinstance(hw, ClusterSpec) and (hw.n, hw.m) != (n, m):
        raise ValueError(f"cluster grid {(hw.n, hw.m)} != tile grid {(n, m)}")
    if partition is not None and (partition.n, partition.m) != (n, m):
        raise ValueError(
            f"partition grid {(partition.n, partition.m)} != tile grid {(n, m)}"
        )
    if isinstance(groups, str):
        groups = tuple(
            optimize_grouping(
                input_hw, layers, n, m,
                hw if isinstance(hw, ClusterSpec) else resolve_hw_profile(hw),
                batch=batch, schedule=schedule, crossover=crossover,
                mem_limit=mem_limit, partition=partition, pipeline=pipeline,
                microbatches=microbatches, wire_codec=wire_codec,
            )
        )
    else:
        groups = tuple(no_grouping(len(layers))) if groups is None else tuple(groups)
        groups = _resolve_crossover(
            input_hw, layers, groups, crossover, n, m,
            hw if isinstance(hw, ClusterSpec) else resolve_hw_profile(hw),
            batch, schedule, mem_limit, partition, wire_codec,
        )
    validate_profile(groups, len(layers))
    cross = crossover_of(groups)
    pfirst = pipeline_first_of(groups)
    if inference and pfirst is not None:
        raise ValueError(
            "inference plans cannot carry pipeline-mode groups: a serve "
            "step needs a single-shot forward layout; use a spatial/data "
            "grouping profile"
        )
    stages = _derive_stages(groups, layers, n, m, pfirst, schedule)

    map_hw = [tuple(input_hw)]
    for l in layers:
        h, w = map_hw[-1]
        map_hw.append((l.out_extent(h), l.out_extent(w)))

    # The tile partition covers the spatial prefix through the first
    # non-spatial layer's input; data- and pipeline-mode layers hold full
    # maps and are exempt.
    tail_first = cross if cross is not None else pfirst
    last = len(layers) if tail_first is None else tail_first
    if partition is None and isinstance(hw, ClusterSpec):
        partition = cluster_partition(input_hw, layers, hw, tail_first)
    strides = [l.stride for l in layers[:last]]
    try:
        row_bounds = derive_axis_bounds(
            partition.row_bounds if partition else None, strides,
            [map_hw[l][0] for l in range(last + 1)], n
        )
        col_bounds = derive_axis_bounds(
            partition.col_bounds if partition else None, strides,
            [map_hw[l][1] for l in range(last + 1)], m
        )
    except ValueError as e:
        raise ValueError(
            f"cannot partition map extents over the {n}x{m} tile grid: {e}; "
            "use a coarser grid, an earlier crossover, or different boundaries"
        ) from None
    if partition is None:
        partition = TilePartition(row_bounds[0], col_bounds[0])
    tile_rows = [bounds_sizes(b) for b in row_bounds]
    tile_cols = [bounds_sizes(b) for b in col_bounds]
    shard_hw = [(max(r), max(c)) for r, c in zip(tile_rows, tile_cols)]
    for li in range(last + 1, len(layers) + 1):
        h, w = map_hw[li]
        tile_rows.append((h,) * n)
        tile_cols.append((w,) * m)
        shard_hw.append((h, w))
    if pfirst is not None and any(
        len(set(tile_rows[l])) > 1 or len(set(tile_cols[l])) > 1 for l in range(last + 1)
    ):
        raise ValueError(
            "pipeline plans require a uniform tile partition over the "
            "spatial prefix (the stage-entry gather slices equal "
            "microbatch blocks); rebalance the partition or drop the "
            "pipeline tail"
        )

    # Group halos + per-layer remaining halos (zero for data- and
    # pipeline-mode groups: full maps have no neighbours).
    group_halos: list[tuple[int, int, int, int]] = []
    rem_halos: list[tuple[int, int, int, int]] = [None] * len(layers)  # type: ignore
    group_of_layer: list[int] = [0] * len(layers)
    for gi, g in enumerate(groups):
        if g.mode != "spatial":
            group_halos.append((0, 0, 0, 0))
            for l in g.layers:
                group_of_layer[l] = gi
                rem_halos[l] = (0, 0, 0, 0)
            continue
        hl = hh = 0
        sprod = 1
        for l in g.layers:
            p = layers[l].padding
            q = layers[l].kernel - layers[l].stride - p
            hl += p * sprod
            hh += q * sprod
            sprod *= layers[l].stride
        group_halos.append((hl, hh, hl, hh))
        # The exchange ships at most one neighbour strip per side, so the
        # group halo must fit inside the smallest neighbouring tile.
        if min(tile_rows[g.start]) < max(hl, hh) or min(tile_cols[g.start]) < max(hl, hh):
            raise ValueError(
                f"group ({g.start}, {g.end}) halo ({hl}, {hh}) exceeds the "
                f"smallest tile of partition rows={tile_rows[g.start]} "
                f"cols={tile_cols[g.start]}; use a finer grouping or a less "
                "skewed partition"
            )
        cur_lo, cur_hi = hl, hh
        for l in g.layers:
            group_of_layer[l] = gi
            p = layers[l].padding
            q = layers[l].kernel - layers[l].stride - p
            cur_lo = (cur_lo - p) // layers[l].stride
            cur_hi = (cur_hi - q) // layers[l].stride
            rem_halos[l] = (cur_lo, cur_hi, cur_lo, cur_hi)
        if cur_lo != 0 or cur_hi != 0:
            raise ValueError(f"group ({g.start}, {g.end}) does not consume its halo")

    return StackPlan(
        layers=layers,
        groups=groups,
        n=n,
        m=m,
        input_hw=tuple(input_hw),
        map_hw=tuple(map_hw),
        shard_hw=tuple(shard_hw),
        group_halos=tuple(group_halos),
        rem_halos=tuple(rem_halos),
        group_of_layer=tuple(group_of_layer),
        backend=backend,
        schedule=schedule,
        block_oh=block_oh,
        crossover=cross,
        partition=partition,
        tile_rows=tuple(tile_rows),
        tile_cols=tuple(tile_cols),
        ragged_exec=ragged_exec,
        stages=stages,
        wire_codec=wire_codec,
        inference=inference,
    )


def _derive_stages(groups, layers, n: int, m: int, pfirst: int | None,
                   schedule: str) -> tuple[tuple[int, int], ...]:
    """A pipeline tail's per-stage flat tile ranges (equal, contiguous),
    after the executor's structural checks, each with its named error: a
    feasible stage count, no BN layer inside a stage, the sync schedule."""
    if pfirst is None:
        return ()
    pipe_groups = [g for g in groups if g.mode == "pipeline"]
    s_count = len(pipe_groups)
    tail_layers = len(layers) - pfirst
    feas = feasible_stage_counts(n, m, tail_layers)
    if s_count not in feas:
        raise ValueError(
            f"{s_count} pipeline stages are infeasible on the {n}x{m} "
            f"grid with a {tail_layers}-layer tail: stage subsets must "
            "be equal-sized and row-aligned (n==1, m==1, or "
            "devices-per-stage divisible by m) so the inter-stage "
            "hand-off is one axis-aligned ppermute; feasible counts: "
            f"{feas or 'none'}"
        )
    for g in pipe_groups:
        for l in g.layers:
            if layers[l].batch_norm:
                raise ValueError(
                    f"layer {l} has batch_norm=True inside a pipeline "
                    "stage: BN needs batch statistics over every tile of "
                    "the map, which one stage's tiles do not hold; keep BN "
                    "layers in the spatial prefix or build the stack with "
                    "batch_norm=False"
                )
    if schedule == "overlap":
        raise ValueError(
            "schedule='overlap' cannot combine with a pipeline tail; "
            "use schedule='sync'"
        )
    per_stage = (n * m) // s_count
    return tuple((s * per_stage, (s + 1) * per_stage) for s in range(s_count))


PLAN_MANIFEST_VERSION = 3


def plan_manifest(plan: StackPlan, cluster: ClusterSpec | None = None) -> dict:
    """JSON-serializable description of a StackPlan: layer stack, tile grid,
    partition boundaries, grouping profile, compute knobs and optionally the
    ClusterSpec the plan was balanced for - the reference's manifest."""
    return {
        "version": PLAN_MANIFEST_VERSION,
        "input_hw": list(plan.input_hw),
        "n": plan.n,
        "m": plan.m,
        "layers": [dataclasses.asdict(l) for l in plan.layers],
        "groups": [[g.start, g.end, g.mode] for g in plan.groups],
        "crossover": plan.crossover,
        "stages": [list(s) for s in plan.stages],
        "partition": None
        if plan.partition is None
        else {
            "row_bounds": list(plan.partition.row_bounds),
            "col_bounds": list(plan.partition.col_bounds),
        },
        "backend": plan.backend,
        "schedule": plan.schedule,
        "block_oh": plan.block_oh,
        "ragged_exec": plan.ragged_exec,
        "wire_codec": plan.wire_codec,
        "inference": plan.inference,
        "cluster": None if cluster is None else cluster_manifest(cluster),
    }


_log = logging.getLogger("repro_torch.core")

# the reference's conv backends and the port's that compute the same
# function: a manifest JAX wrote names "xla" or "pallas"
_BACKEND_OF_REFERENCE = {"xla": "torch", "pallas": "cuda"}


def plan_from_manifest(man: dict) -> StackPlan:
    """Rebuild the StackPlan a manifest describes - explicit groups and
    partition, so the planner re-derives every geometry and the result is
    dataclass-equal to the plan that was saved.  A manifest the reference
    wrote maps its backend onto the port's (``pallas`` -> ``cuda``, ``xla``
    -> ``torch``); v1/v2 manifests read ``wire_codec`` and ``inference`` as
    their defaults, as the reference does."""
    layers = tuple(LayerDef(**ld) for ld in man["layers"])
    groups = tuple(Group(s, e, mode) for s, e, mode in man["groups"])
    part = man.get("partition")
    partition = (
        None
        if part is None
        else TilePartition(tuple(part["row_bounds"]), tuple(part["col_bounds"]))
    )
    backend = man.get("backend", "torch")
    return build_stack_plan(
        tuple(man["input_hw"]),
        layers,
        man["n"],
        man["m"],
        groups,
        backend=_BACKEND_OF_REFERENCE.get(backend, backend),
        schedule=man.get("schedule", "sync"),
        block_oh=man.get("block_oh"),
        partition=partition,
        ragged_exec=man.get("ragged_exec", "spec"),
        wire_codec=man.get("wire_codec", "none"),
        inference=man.get("inference", False),
    )


def replan_stack(
    plan: StackPlan,
    hw: HardwareProfile | ClusterSpec | str | None,
    n: int | None = None,
    m: int | None = None,
    *,
    batch: int = 1,
    groups: Sequence[Group] | str | None = "auto",
    crossover: int | str | None = "auto",
    mem_limit: float | None = None,
    partition: TilePartition | None = None,
    pipeline: int | str | None = None,
) -> StackPlan:
    """Rebuild ``plan`` against a changed cluster (elastic replan, DESIGN.md
    §10): the same layer stack and backend/schedule/executor knobs on the
    new device set, through the whole planner - makespan balancing, the
    grouping DP (``groups="auto"``) and the crossover scan
    (``crossover="auto"``), so the survivors get a partition balanced for
    them.  ``n``/``m`` default to the ClusterSpec's grid (required for
    other ``hw`` forms).  Params are partition-independent, so a TrainState
    trains on the new plan as it is.

    Degradation: if the cost-optimal grouping/crossover is infeasible
    under the rebalanced partition (a skewed mesh can shrink the smallest
    tile below a fused group's halo), fall back to ungrouped layers, then
    to ungrouped all-spatial.  A plan that had a pipeline tail (or an
    explicit ``pipeline``) first replans with ``pipeline="auto"``, so the
    survivors get stages re-packed for them; the next rung drops the
    pipeline search."""
    if isinstance(hw, ClusterSpec):
        n = hw.n if n is None else n
        m = hw.m if m is None else m
    if n is None or m is None:
        raise ValueError("replan_stack needs n, m when hw is not a ClusterSpec")
    if pipeline is None and plan.stages:
        pipeline = "auto"

    def attempt(g, x, p):
        return build_stack_plan(
            plan.input_hw,
            plan.layers,
            n,
            m,
            g,
            backend=plan.backend,
            schedule=plan.schedule,
            block_oh=plan.block_oh,
            hw=hw,
            batch=batch,
            crossover=x,
            mem_limit=mem_limit,
            partition=partition,
            ragged_exec=plan.ragged_exec,
            pipeline=p if g == "auto" else None,
            wire_codec=plan.wire_codec,
            inference=plan.inference,
        )

    ladder = [(groups, crossover, pipeline)]
    if pipeline is not None:
        ladder.append((groups, crossover, None))
    if groups is not None:
        ladder.append((None, crossover, None))
    if crossover is not None:
        ladder.append((None, None, None))
    last_err: Exception | None = None
    for i, (g, x, p) in enumerate(ladder):
        try:
            return attempt(g, x, p)
        except ValueError as e:
            last_err = e
            if i + 1 < len(ladder):
                _log.warning(
                    "replan with groups=%r crossover=%r pipeline=%r infeasible (%s); "
                    "degrading to groups=%r crossover=%r pipeline=%r",
                    g, x, p, e, *ladder[i + 1])
    raise last_err


def _ragged_group_geom(plan: StackPlan, gi: int) -> dict:
    """Static geometry of one spatial group of a ragged plan (DESIGN.md §8):
    the canonical (padded) extended extents per layer.

    For layer k of the group (input halos (lo, hi), output halos (lo', hi'))
    a tile's valid extended input occupies rows ``[0, lo + own + hi)`` of the
    padded layout and its valid outputs rows ``[0, lo' + own' + hi')``.  The
    canonical input extent covers both the largest valid window and the
    largest window any tile's valid outputs read, ``(max_valid_out - 1) *
    stride + kernel`` (the last tile's off-map reach can pass its valid
    input rows; those reads hit zeros, the global SAME padding)."""
    g = plan.groups[gi]
    halos = [plan.group_halos[gi]] + [plan.rem_halos[l] for l in g.layers]
    ein = []
    for k, l in enumerate(g.layers):
        top, bottom, left, right = halos[k]
        ntop, nbot, nleft, nright = halos[k + 1]
        ker, s = plan.layers[l].kernel, plan.layers[l].stride
        rows = max(
            max(plan.tile_rows[l]) + top + bottom,
            max((ntop + r + nbot - 1) * s + ker for r in plan.tile_rows[l + 1]),
        )
        cols = max(
            max(plan.tile_cols[l]) + left + right,
            max((nleft + c + nright - 1) * s + ker for c in plan.tile_cols[l + 1]),
        )
        ein.append((rows, cols))
    # the canonical output of layer k is the input of layer k+1; the group's
    # output is the padded core (the next group exchanges its own halos)
    eout = ein[1:] + [(max(plan.tile_rows[g.end + 1]), max(plan.tile_cols[g.end + 1]))]
    return {"ein": ein, "eout": eout, "halos": halos}


def _block_tables(rows, cols) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Whole-grid per-axis tables (sizes, offsets) as the tiles at hand
    index them: the tables on the virtual mesh, the block's rows of them on
    ranks."""
    mesh = active_tile_mesh()
    return local_table(rows, 0, mesh), local_table(cols, 1, mesh)


def _offsets(sizes: tuple[int, ...]) -> tuple[int, ...]:
    out, acc = [], 0
    for s in sizes:
        out.append(acc)
        acc += s
    return tuple(out)


def _apply_group_ragged(x: torch.Tensor, params: Sequence[dict], plan: StackPlan, gi: int, *,
                        batch_global: int, wire: WireCtx | None = None) -> torch.Tensor:
    """One spatial group of a ragged plan under the padded executor
    (DESIGN.md §8).  ``x`` enters as the padded core ``(n, m, b, Hmax, Wmax,
    c)``, pad slots zero; the padded exchange assembles the canonical
    extended tiles, then every layer runs conv -> refit -> mask
    (``apply_layer_local_ragged``), one conv call per layer for all tiles,
    restoring the padded-tile invariant for the next layer and group.  On
    ranks the masks read the block's rows of the size and offset tables."""
    g = plan.groups[gi]
    geom = _ragged_group_geom(plan, gi)
    x = halo_exchange_2d_ragged(x, plan.group_halos[gi], plan.tile_rows[g.start],
                                plan.tile_cols[g.start], out_extents=geom["ein"][0], wire=wire)
    for k, l in enumerate(g.layers):
        rows, cols = plan.tile_rows[l + 1], plan.tile_cols[l + 1]
        x = apply_layer_local_ragged(
            x,
            params[l],
            plan.layers[l],
            out_halo=geom["halos"][k + 1],
            out_size=_block_tables(rows, cols),
            out_off=_block_tables(_offsets(rows), _offsets(cols)),
            canon_out_hw=geom["eout"][k],
            map_out_hw=plan.map_hw[l + 1],
            backend=plan.backend,
            block_oh=plan.block_oh,
            inference=plan.inference,
            batch_global=batch_global,
        )
    return x


def _apply_group_spec(x: torch.Tensor, params: Sequence[dict], plan: StackPlan, gi: int, *,
                      batch_global: int, wire: WireCtx | None = None) -> torch.Tensor:
    """One spatial group of a ragged plan under the shape-specialised
    executor (DESIGN.md §9).  The tile shapes are deduplicated at the group
    input (``_switch_by_size``: stride alignment makes the group-start size
    the complete per-axis key, so a 3x3 grid of (144, 144, 128) rows and
    columns has 4 classes, not 9), and every layer runs one conv per class
    on the class's true extents (``apply_layer_local_spec``).  The spec
    exchange reads valid windows only; pad slots past a class's window are
    never read, so only the off-map rim is masked mid-group.  On ranks a
    rank runs the classes of its own tiles (one conv each; a class it holds
    no tile of, not at all) and its block's rows of the offset table."""
    g = plan.groups[gi]
    geom = _ragged_group_geom(plan, gi)
    x = halo_exchange_2d_spec(x, plan.group_halos[gi], plan.tile_rows[g.start],
                              plan.tile_cols[g.start], out_extents=geom["ein"][0], wire=wire)
    classes = _switch_by_size(plan.tile_rows[g.start], plan.tile_cols[g.start],
                              active_tile_mesh())
    # cumulative stride products: group-start sizes over cum[k] are the
    # layer-k tile sizes (exact by stride alignment)
    cum = [1]
    for l in g.layers:
        cum.append(cum[-1] * plan.layers[l].stride)
    for k, l in enumerate(g.layers):
        top, bottom, left, right = geom["halos"][k]
        ntop, nbot, nleft, nright = geom["halos"][k + 1]
        class_io = tuple(
            ((top + r0 // cum[k] + bottom, left + c0 // cum[k] + right),
             (ntop + r0 // cum[k + 1] + nbot, nleft + c0 // cum[k + 1] + nright))
            for (r0, c0), _ in classes
        )
        mask = (l != g.end) and any(geom["halos"][k + 1])
        out_off = _block_tables(_offsets(plan.tile_rows[l + 1]), _offsets(plan.tile_cols[l + 1]))
        x = apply_layer_local_spec(
            x,
            params[l],
            plan.layers[l],
            classes=[tiles for _, tiles in classes],
            class_io=class_io,
            out_halo=geom["halos"][k + 1],
            canon_out_hw=geom["eout"][k],
            map_out_hw=plan.map_hw[l + 1],
            out_off=out_off if mask else None,
            mask_offmap=mask,
            backend=plan.backend,
            block_oh=plan.block_oh,
            inference=plan.inference,
            batch_global=batch_global,
        )
    return x


def apply_stack_local(params: Sequence[dict], x: torch.Tensor, plan: StackPlan,
                      wire: WireCtx | None = None) -> torch.Tensor:
    """Forward through all groups on tiles ``x`` = (n, m, b, h/n, w/m, c).

    schedule="sync": at each group input a 2-round halo exchange, then the
    group's layers.  schedule="overlap": a group lead with a nonzero halo
    goes through the packed exchange and the interior/boundary split
    (``spatial.apply_group_lead_overlap``); the rest of the group is
    unchanged.  Hybrid plans: at the first data-mode group the tiles are
    resharded into batch blocks of full maps (``reshard_spatial_to_data``)
    and every later layer runs on them with no exchange
    (``apply_layer_data``), so a hybrid plan returns
    ``(n, m, b/(n*m), OH, OW, C)``.  Training BN averages over the b
    images of the map on both sides of the crossover (the virtual mesh has
    no batch axis, so b is the entry batch).

    A pipeline plan's tiles leave at its first pipeline group: the stages
    run in the tick executor (``_make_pipeline_local``).

    Non-uniform partitions: ``x`` is the padded layout ``(n, m, b, Hmax,
    Wmax, c)`` and every spatial group runs the shape-specialised executor
    (``_apply_group_spec``) or, when ``plan.ragged_exec == "padded"``, the
    padded one (``_apply_group_ragged``), both with the sync exchange
    whatever the schedule; the crossover goes through the ragged reshard.
    Uniform plans take exactly the path they took before partitions.

    ``wire`` (DESIGN.md §12) reaches every exchange and reshard; ``None``
    runs them uncompressed, as before codecs."""
    bg = x.shape[2]
    uniform = plan.is_uniform
    for gi, g in enumerate(plan.groups):
        if g.mode == "pipeline":
            break
        if g.mode == "data":
            if gi == 0 or plan.groups[gi - 1].mode != "data":
                if uniform:
                    x = reshard_spatial_to_data(x, wire=wire)
                else:
                    x = reshard_spatial_to_data_ragged(x, plan.tile_rows[g.start],
                                                       plan.tile_cols[g.start], wire=wire)
            for l in g.layers:
                x = apply_layer_data(
                    x,
                    params[l],
                    plan.layers[l],
                    map_out_hw=plan.map_hw[l + 1],
                    batch_global=bg,
                    backend=plan.backend,
                    block_oh=plan.block_oh,
                    inference=plan.inference,
                )
            continue
        if not uniform:
            group_fn = _apply_group_spec if plan.ragged_exec == "spec" else _apply_group_ragged
            x = group_fn(x, params, plan, gi, batch_global=bg, wire=wire)
            continue
        layers = list(g.layers)
        if plan.schedule == "overlap" and any(plan.group_halos[gi]):
            lead = layers.pop(0)
            x = apply_group_lead_overlap(
                x,
                params[lead],
                plan.layers[lead],
                halo=plan.group_halos[gi],
                out_halo=plan.rem_halos[lead],
                shard_out_hw=plan.shard_hw[lead + 1],
                map_out_hw=plan.map_hw[lead + 1],
                mask_offmap=(lead != g.end),
                backend=plan.backend,
                block_oh=plan.block_oh,
                inference=plan.inference,
                wire=wire,
            )
        else:
            x = halo_exchange_2d(x, plan.group_halos[gi], wire=wire)
        for l in layers:
            x = apply_layer_local(
                x,
                params[l],
                plan.layers[l],
                out_halo=plan.rem_halos[l],
                shard_out_hw=plan.shard_hw[l + 1],
                map_out_hw=plan.map_hw[l + 1],
                mask_offmap=(l != g.end),
                backend=plan.backend,
                block_oh=plan.block_oh,
                inference=plan.inference,
            )
    return x


def _in_split(plan: StackPlan, mesh: TileMesh):
    """Global (B, H, W, C) -> the executor's input tiles: uniform tiles, or
    the padded layout of the plan's input partition (``TileMesh.split``)."""
    if plan.is_uniform:
        return mesh.split
    return lambda x: mesh.split(x, plan.tile_rows[0], plan.tile_cols[0])


def _out_spec(plan: StackPlan, mesh: TileMesh):
    """Output layout of the executor, as ``(split, merge)`` between global
    (B, OH, OW, C) arrays and the executor's output tensor: spatial tiles
    for all-spatial plans (padded by the output partition on a ragged one);
    batch blocks of full maps after a crossover (tile (i, j) holds block
    i*m + j, ``TileMesh.split_batch``)."""
    if plan.crossover is not None:
        return mesh.split_batch, mesh.merge_batch
    if plan.is_uniform:
        return mesh.split, mesh.merge
    rows, cols = plan.tile_rows[-1], plan.tile_cols[-1]
    return (lambda t: mesh.split(t, rows, cols)), (lambda y: mesh.merge(y, rows, cols))


def _spec_core_loss(y: torch.Tensor, t_tiles: torch.Tensor, plan: StackPlan, loss_local):
    """The loss of a spec plan's output (DESIGN.md §9): per output shape
    class, its tiles' valid cores and their spans of the target (``t_tiles``,
    the target packed by the output partition), through ``loss_local`` on
    the TRUE extents - exact sums and exact counts, with no validity mask
    and no count rescale.  The reference slices one tile per ``lax.switch``
    branch; here each class's tiles go through ``loss_local`` together.  On
    ranks each rank scores the classes of its own tiles."""
    n, m = y.shape[:2]
    yf = y.reshape(n * m, *y.shape[2:])
    tf = t_tiles.reshape(n * m, *t_tiles.shape[2:])
    s = c = 0.0
    for (r, w), tiles in _switch_by_size(plan.tile_rows[-1], plan.tile_cols[-1],
                                         active_tile_mesh()):
        idx = plan_constant(tuple(tiles), y.device)
        yc = yf[:, :, :r, :w].index_select(0, idx)[None]
        tc = tf[:, :, :r, :w].index_select(0, idx)[None]
        sk, ck = loss_local(yc, tc)
        s, c = s + sk, c + ck
    return s, c


def _ragged_count_scale(plan: StackPlan) -> float:
    """The valid share of the padded output tiles - scales ``loss_local``'s
    element count under the padded executor (pad slots hold y = t = 0, so
    the sum is already exact; only the count over-reads).  Needs a count
    proportional to the element count, as ``l2_loss_local``'s is.  On
    ranks every block holds as many padded tiles, so the ranks' scaled
    counts sum to the grid's valid count."""
    rows, cols = plan.tile_rows[-1], plan.tile_cols[-1]
    return (sum(rows) * sum(cols)) / float(plan.n * plan.m * max(rows) * max(cols))


def _tiles_loss(plan: StackPlan, mesh: TileMesh, loss_local):
    """``(y, target) -> (sum, count)`` of the executor's output ``y``
    against a global target, in the plan's output layout."""
    split_out, _ = _out_spec(plan, mesh)
    spec = not plan.is_uniform and plan.ragged_exec == "spec" and plan.crossover is None
    padded = not plan.is_uniform and plan.ragged_exec == "padded" and plan.crossover is None

    def fn(y, target):
        t = split_out(torch.as_tensor(target, device=mesh.device))
        if spec:
            return _spec_core_loss(y, t, plan, loss_local)
        s, c = loss_local(y, t)
        return (s, c * _ragged_count_scale(plan)) if padded else (s, c)

    return fn


# ---------------------------------------------------------------------------
# Pipeline-tail executor (DESIGN.md §11): microbatches streaming over the
# stages' tile subsets on the virtual mesh
# ---------------------------------------------------------------------------


def _pipeline_geometry(plan: StackPlan) -> dict:
    """Static geometry of a pipeline tail: the stage groups, tiles per
    stage, the entry layer and the reference's *container* (H, W, C), one
    extent covering every stage-boundary activation.  The reference pads
    every boundary to it, because its per-stage ``lax.switch`` branches
    must share one shape; here each stage's branch is its own call, so
    activations keep their true extents - except on a compressed hand-off,
    whose blocks are encoded at the container extent, as the reference
    encodes them."""
    pg = [g for g in plan.groups if g.mode == "pipeline"]
    dims = []
    for g in pg:
        dims.append((*plan.map_hw[g.start], plan.layers[g.start].in_channels))
        dims.append((*plan.map_hw[g.end + 1], plan.layers[g.end].out_channels))
    return {
        "groups": pg,
        "n_stages": len(pg),
        "per_stage": (plan.n * plan.m) // len(pg),
        "pfirst": pg[0].start,
        "container": tuple(max(d[k] for d in dims) for k in range(3)),
    }


def _stage_shift(plan: StackPlan) -> tuple[str, int]:
    """How "flat index + tiles-per-stage" decomposes into ONE axis-aligned
    shift of the (n x m) grid: ("row"|"col", shift).  Exists by the
    row-alignment feasibility rule (``feasible_stage_counts``): stage
    subsets are whole grid rows (or the grid is a single row/column)."""
    per = (plan.n * plan.m) // len(plan.stages)
    if plan.n == 1:
        return "col", per
    if plan.m == 1:
        return "row", per
    return "row", per // plan.m


def pipeline_schedule_census(n_stages: int, microbatches: int) -> dict:
    """Occupancy census of the fill/drain schedule: stage ``s`` holds real
    work at tick ``t`` iff ``0 <= t - s < M`` (the executor's ``k = t - s``
    arithmetic).  ``bubble`` = idle slot fraction, the measured counterpart
    of the cost model's ``bubble_fraction(S, M) = (S-1)/(S-1+M)`` (idle =
    S*(S-1) slots out of S*(M+S-1))."""
    s_n, mb = n_stages, microbatches
    if s_n < 1 or mb < 1:
        raise ValueError(f"need n_stages >= 1 and microbatches >= 1; got {n_stages}, {microbatches}")
    ticks = mb + s_n - 1
    busy = sum(1 for t in range(ticks) for s in range(s_n) if 0 <= t - s < mb)
    idle = ticks * s_n - busy
    return {
        "stages": s_n,
        "microbatches": mb,
        "ticks": ticks,
        "busy_slots": busy,
        "idle_slots": idle,
        "bubble": idle / (ticks * s_n),
    }


def _check_pipeline_batch(plan: StackPlan, b_mu: int) -> None:
    per = (plan.n * plan.m) // len(plan.stages)
    if b_mu % per:
        raise ValueError(
            f"pipeline stage entry needs the per-microbatch batch ({b_mu}) "
            f"divisible by the devices per stage ({per}); pick "
            "batch/grad_accum so each microbatch spreads over one stage's "
            "device subset"
        )


def _stage_span(plan: StackPlan, s: int) -> tuple[int, int, int]:
    """Stage ``s``'s tiles as a span of the hand-off axis: (tile dimension,
    first, end).  Stages are whole grid rows, or column ranges of a
    one-row grid (``_stage_shift``)."""
    kind, shift = _stage_shift(plan)
    return (0 if kind == "row" else 1), s * shift, (s + 1) * shift


def _stage_tiles(plan: StackPlan, s: int, mesh) -> list[tuple[int, int]]:
    """The tiles of stage ``s`` among those ``mesh`` holds here (the whole
    grid on the virtual mesh, a rank's block on ranks): (flat index into
    the tiles held, stage rank), in the block's row-major order.  Stage
    rank q holds microbatch block ``[q*bp, (q+1)*bp)``."""
    lo, hi = plan.stages[s]
    tiles = range(plan.n * plan.m) if mesh is None else mesh.block_tiles()
    return [(i, r - lo) for i, r in enumerate(tiles) if lo <= r < hi]


def _stage_handoff(y: torch.Tensor, plan: StackPlan, s: int,
                   wire: WireCtx | None = None) -> torch.Tensor:
    """Stage ``s``'s output -> stage ``s + 1``'s input, each as the blocks
    ``(tiles, bp, H, W, C)`` of the stage's tiles held here (the whole
    grid's on the virtual mesh, the rank's block's on ranks; none is an
    empty first dimension), in tile order.  The blocks are laid on the
    held tiles (zeros on every other stage's), moved by ``_stage_shift``'s
    one axis-aligned shift of stage ``s``'s senders, and stage ``s + 1``'s
    tiles are read back: each tile receives the block of the tile of the
    same stage rank one stage up, as the reference's ``ppermute`` delivers
    it.  On ranks a stage tile's block goes to the rank of its destination,
    one or more blocks away.  Under a codec (a stateless ``wire``) every
    block is zero-padded to the reference's container before it is encoded
    and cut back to its extent after the decode.  The tick schedule runs
    it on detached blocks and carries the cotangent back itself
    (``_stage_handoff_back``)."""
    return _stage_hop(y, plan, s, s + 1, wire, adjoint=False)


def _stage_handoff_back(ct: torch.Tensor, plan: StackPlan, s: int,
                        wire: WireCtx | None = None) -> torch.Tensor:
    """The adjoint of ``_stage_handoff(., plan, s)``: the cotangent of stage
    ``s + 1``'s input blocks -> that of stage ``s``'s output blocks, by the
    reverse shift; under a codec EF-encoded against a zero residual (the
    stateless backward of a compressed strip)."""
    return _stage_hop(ct, plan, s + 1, s, wire, adjoint=True)


def _stage_hop(y: torch.Tensor, plan: StackPlan, src: int, dst: int, wire: WireCtx | None,
               adjoint: bool) -> torch.Tensor:
    mesh = active_tile_mesh()
    bn, bm = (plan.n, plan.m) if mesh is None else mesh.block
    dim, lo, hi = _stage_span(plan, src)
    blk = y.shape[1:]
    if wire is not None:
        hc, wc, cc = _pipeline_geometry(plan)["container"]
        y = F.pad(y, (0, cc - blk[3], 0, wc - blk[2], 0, hc - blk[1]))
    src_idx = plan_constant(tuple(i for i, _ in _stage_tiles(plan, src, mesh)), y.device)
    grid = y.new_zeros((bn * bm, *y.shape[1:])).index_copy_(0, src_idx, y)
    grid = grid.reshape(bn, bm, *y.shape[1:])
    shift, span = (dst - src) * (hi - lo), (lo, hi)
    if wire is None:
        moved = _move(grid, dim, shift, span=span)
    else:
        payload = (ef_encode(wire.codec, grid, torch.zeros_like(grid), GRID_DIMS)[0] if adjoint
                   else wire.codec.encode(grid, GRID_DIMS))
        moves = [_move_start(p, dim, shift, tag, span=span) for tag, p in enumerate(payload)]
        moved = wire.codec.decode([mv.wait() for mv in moves], grid.shape, grid.dtype,
                                  GRID_DIMS)
    dst_idx = plan_constant(tuple(i for i, _ in _stage_tiles(plan, dst, mesh)), y.device)
    out = moved.reshape(bn * bm, *y.shape[1:]).index_select(0, dst_idx)
    return out[..., :blk[1], :blk[2], :blk[3]] if wire is not None else out


class _PipelineRun:
    """One step of the tick schedule on the tiles held here, and its
    adjoint, walked in an order every rank shares (``_make_pipeline_local``
    says which).  ``forward`` keeps each busy slot's graph, from a detached
    input leaf to its output (or its loss), and each microbatch's entry
    graph; ``backward`` runs them in reverse tick order."""

    def __init__(self, plan: StackPlan, mesh: TileMesh, loss_local, microbatches: int):
        self.plan, self.loss_local, self.mb = plan, loss_local, microbatches
        self.mesh = mesh
        self.dmesh = _dist_of(mesh)
        self.geom = _pipeline_geometry(plan)
        self.wire = _stateless_wire(plan)
        self.census = None
        self.here = [_stage_tiles(plan, s, self.dmesh) for s in range(self.geom["n_stages"])]

    def _branch(self, s, params, x):
        """Stage ``s``'s layers over the blocks ``x`` (tiles, bp, H, W, C),
        as ONE call per layer over them flattened into the batch."""
        tiles = x.shape[0]
        x = x.reshape(1, 1, -1, *x.shape[2:])
        for l in self.geom["groups"][s].layers:
            x = apply_layer_data(
                x,
                params[l],
                self.plan.layers[l],
                map_out_hw=self.plan.map_hw[l + 1],
                batch_global=x.shape[2],
                backend=self.plan.backend,
                block_oh=self.plan.block_oh,
                inference=self.plan.inference,
            )
        return x.reshape(tiles, -1, *x.shape[3:])

    def _blocks(self, maps, s):
        """Stage ``s``'s stage-rank blocks of the microbatch ``maps`` held
        here: (tiles, bp, ...)."""
        per = self.geom["per_stage"]
        q = plan_constant(tuple(r for _, r in self.here[s]), maps.device)
        return maps.reshape(per, -1, *maps.shape[1:]).index_select(0, q)

    def _entry(self, params, x):
        """Microbatch ``x``'s full maps at the pipeline's entry: the spatial
        prefix on the tiles held here (``apply_stack_local``, which stops at
        the tail), then the reference's two tiled all-gathers (rows, then
        columns: ``dist.all_gather_axis``, differentiable; nothing on the
        virtual mesh)."""
        h = apply_stack_local(params, self.mesh.split(x), self.plan, self.wire)
        if self.dmesh is not None:
            h = all_gather_axis(all_gather_axis(h, 0, self.dmesh), 1, self.dmesh)
        n, m, b, hh, ww, c = h.shape
        return h.permute(2, 0, 3, 1, 4, 5).reshape(b, n * hh, m * ww, c)

    def _empty(self, s: int, bp: int, like: torch.Tensor, inp: bool) -> torch.Tensor:
        """No blocks of stage ``s``'s input (``inp``) or output: what a rank
        holding none of its tiles hands on, (0, bp, H, W, C)."""
        g = self.geom["groups"][s]
        l = g.start if inp else g.end + 1
        c = self.plan.layers[g.start].in_channels if inp else self.plan.layers[g.end].out_channels
        return like.new_zeros((0, bp, *self.plan.map_hw[l], c))

    def forward(self, leaves, params, xs, ts, grad: bool) -> dict:
        n_st, mb, per = self.geom["n_stages"], self.mb, self.geom["per_stage"]
        last, bp = n_st - 1, xs.shape[1] // per
        census = {"ticks": 0, "busy_slots": 0, "prefix_passes": 0}
        st = {"slots": {}, "entries": {}, "leaves": leaves, "bp": bp, "like": xs.new_zeros(()),
              "s": torch.zeros((), dtype=torch.promote_types(xs.dtype, torch.float32),
                               device=xs.device), "c": 0.0}
        prev: dict[int, torch.Tensor] = {}
        for t in range(mb + n_st - 1):
            out: dict[int, torch.Tensor] = {}
            for s in range(n_st):
                k = t - s
                if not 0 <= k < mb:
                    continue                         # an idle slot: nothing runs
                census["busy_slots"] += 1
                if s == 0:
                    census["prefix_passes"] += 1
                    if self.geom["pfirst"]:
                        with torch.set_grad_enabled(grad):
                            full = self._entry(params, xs[k])
                        st["entries"][k] = full
                        x_in = self._blocks(full.detach(), 0)
                    else:
                        x_in = self._blocks(xs[k], 0)   # no prefix: the maps are whole
                else:
                    with torch.no_grad():
                        x_in = _stage_handoff(prev[s - 1], self.plan, s - 1, self.wire)
                if not self.here[s]:
                    if s < last:
                        out[s] = self._empty(s, bp, xs, inp=False)
                    continue
                if grad and (s > 0 or self.geom["pfirst"]):
                    x_in.requires_grad_(True)
                with torch.set_grad_enabled(grad):
                    y = self._branch(s, params, x_in)
                    if s == last:
                        t_blk = self._blocks(ts[k], last)
                        s_l, c_l = self.loss_local(y.reshape(-1, *y.shape[2:]),
                                                   t_blk.reshape(-1, *t_blk.shape[2:]))
                        st["s"], st["c"] = st["s"] + s_l, st["c"] + c_l
                        y = s_l
                    else:
                        out[s] = y.detach()
                if grad:
                    st["slots"][(s, k)] = (x_in, y)
            prev = out
            census["ticks"] += 1
        self.census = census
        return st

    def backward(self, st, seed) -> list:
        """The gradients of ``seed`` x the forward's loss sum, of every leaf
        (None where it took none here)."""
        n_st, mb = self.geom["n_stages"], self.mb
        leaves = st["leaves"]
        acc: list = [None] * len(leaves)

        def take(outputs, grad_outputs, inputs):
            gs = torch.autograd.grad(outputs, leaves + inputs, grad_outputs, allow_unused=True)
            for i, g in enumerate(gs[:len(leaves)]):
                if g is not None:
                    acc[i] = g if acc[i] is None else acc[i].add_(g)
            return gs[len(leaves):]

        ct_out: dict = {}
        for t in reversed(range(mb + n_st - 1)):
            for s in reversed(range(n_st)):
                k = t - s
                if not 0 <= k < mb:
                    continue
                ct_in = None
                if (s, k) in st["slots"]:
                    x_in, y = st["slots"].pop((s, k))
                    ct = (ct_out.pop((s, k)) if s < n_st - 1
                          else torch.as_tensor(seed, dtype=y.dtype, device=y.device))
                    got = take(y, ct, [x_in] if x_in.requires_grad else [])
                    ct_in = got[0] if got else None
                elif s > 0 or k in st["entries"]:
                    ct_out.pop((s, k), None)
                    ct_in = self._empty(s, st["bp"], st["like"], inp=True)
                if s > 0:
                    ct_out[(s - 1, k)] = _stage_handoff_back(ct_in, self.plan, s - 1, self.wire)
                elif k in st["entries"]:
                    full = st["entries"].pop(k)
                    ct_full = self._blocks_back(full, ct_in)
                    take(full, ct_full, [])
        return acc

    def _blocks_back(self, maps, ct):
        """The adjoint of ``_blocks(maps, 0)``: ``ct`` (tiles, bp, ...) laid
        at the stage ranks held here of a zero microbatch cotangent."""
        per = self.geom["per_stage"]
        q = plan_constant(tuple(r for _, r in self.here[0]), maps.device)
        out = maps.new_zeros((per, maps.shape[0] // per, *maps.shape[1:]))
        return out.index_copy_(0, q, ct).reshape(maps.shape)


def _make_pipeline_local(plan: StackPlan, mesh: TileMesh, loss_local, *,
                         microbatches: int) -> _PipelineRun:
    """The pipeline executor: a ``_PipelineRun`` whose ``forward(leaves,
    params, xs, ts, grad)`` runs one step on xs (M, b, H, W, C) and ts (M, b,
    OH, OW, C') global microbatches and returns its state (the loss sum
    ``"s"`` and count ``"c"`` of the tiles held here, the graphs), and whose
    ``backward(state, seed)`` gives every leaf's gradient of ``seed`` x the
    sum.  It walks the ``T = M + S - 1`` fill/drain ticks of the
    reference's tick scan.  At tick ``t`` stage ``s`` owns microbatch
    ``k = t - s``:

    1. stage 0 takes the entry: every tile runs the spatial prefix on
       microbatch k (``apply_stack_local``, which stops at the pipeline
       tail: the reference's ``_apply_spatial_prefix``, the uniform sync
       executor), the tiles are all-gathered into full maps (the
       reference's two tiled all-gathers; on the virtual mesh a reshape)
       and each stage-0 tile takes its stage-rank block ``[rank*bp,
       (rank+1)*bp)`` of the microbatch;
    2. a later stage takes its hand-off: the previous tick's output of the
       stage before it, moved one stage on by ``_stage_handoff``;
    3. the stage's layers run as ONE call per layer over its tiles' blocks
       held here, flattened into the batch, through ``apply_layer_data``
       (collective-free dense programs: stages hold no BN), so each conv
       of a stage is one kernel launch a tick (on ranks: on each rank
       holding tiles of the stage);
    4. the last stage scores microbatch ``t - (S-1)``'s blocks against the
       same blocks of its target.

    Where the port departs from the reference's literal schedule: the
    reference runs every stage at every tick (and the prefix on a clamped
    microbatch past the fill) and masks the idle slots' loss, so their
    cotangents are exactly zero; here only the ``S*M`` busy (stage, tick)
    slots and the M real prefix passes run, which changes no value.  So
    where the reference ``ppermute``s a container-size buffer on every
    device at each of its M + S - 1 ticks (and its transpose in the
    backward), a rank here moves each microbatch's hand-off once per stage
    boundary, forward and back, at the blocks' true extents (the
    container's under a codec), and only where it holds the sending
    stage's tiles: M hand-offs a step per sending block and boundary.
    The entry's two gathers (and their reduce-scatters) run once per
    microbatch, M times a step, where the reference runs them at each
    tick.  ``run.census`` holds the last step's ``ticks``, ``busy_slots``
    (the slots of the schedule) and ``prefix_passes``.

    The adjoint is explicit, not one autograd pass over the ticks: on
    ranks the stages' graphs differ from rank to rank, so autograd's own
    order would not line the ranks' messages up.  Every rank walks the
    same order.  Forward: the ticks in order, the stages in order within a
    tick; at each busy slot stage 0's prefix and gathers (every rank), or
    the hand-off into stage s (the ranks holding stage s-1's or stage s's
    tiles), then the stage's layers on the ranks holding its tiles.  Each
    slot's input is a detached leaf.  Backward: the ticks in reverse, the
    stages in reverse within a tick; at each busy slot the stage's
    backward (its ranks), then the hand-off's adjoint back into stage s-1
    (``_stage_handoff_back``: the leaf's gradient by the reverse shift),
    or for stage 0 the entry's backward on every rank - the gathers'
    reduce-scatters and the prefix's exchanges, with zero cotangents from
    the ranks that hold no stage-0 tile, as the reference also sends them.
    The virtual mesh walks the same schedule, so one rank is bitwise it.

    Under a codec the prefix's exchanges and the hand-off are compressed
    statelessly in both directions (``_stateless_wire``): an EF residual
    would have its cotangents summed across ticks, breaking the
    one-residual-per-exchange bookkeeping (DESIGN.md §12)."""
    return _PipelineRun(plan, mesh, loss_local, microbatches)


class _PipelineLoss(torch.autograd.Function):
    """The pipeline's loss sum of the tiles held here as a function of the
    params' leaves: the forward runs the tick schedule and keeps its
    graphs, the backward runs its adjoint (``_PipelineRun.backward``)."""

    @staticmethod
    def forward(ctx, run, xs, ts, params_tree, *leaves):
        grad = any(v.requires_grad for v in leaves)
        live = [v.detach().requires_grad_(grad) for v in leaves]
        it = iter(live)
        params = [{k: next(it) for k in p} for p in params_tree]
        with tile_mesh_ctx(run.dmesh):
            st = run.forward(live, params, xs, ts, grad)
        ctx.run, ctx.st = run, st
        run.count = st["c"]
        return st["s"].detach()

    @staticmethod
    def backward(ctx, g):
        with tile_mesh_ctx(ctx.run.dmesh):
            grads = ctx.run.backward(ctx.st, g)
        leaves = ctx.st["leaves"]
        ctx.st = None
        # a zero, not None, for a leaf no stage here uses: on ranks every
        # leaf's gradient then takes part in its all-reduce
        return (None, None, None, None,
                *[torch.zeros_like(v) if gi is None else gi for v, gi in zip(leaves, grads)])
def _check_data_batch(plan: StackPlan, batch: int) -> None:
    """Named error for hybrid plans whose per-microbatch batch cannot spread
    over the tile grid, raised before the executor runs."""
    if plan.crossover is None:
        return
    t = plan.n * plan.m
    if batch % t:
        raise ValueError(
            f"data-mode batch split needs the per-microbatch batch ({batch}) "
            f"divisible by the tile count ({plan.n}x{plan.m}={t})"
        )


def _dist_of(mesh: TileMesh) -> DistTileMesh | None:
    """``mesh`` when it spreads the grid over ranks, else None.  Ranks run
    every plan: any grouping, either schedule, a crossover to a data-mode
    tail, any wire codec, a ragged partition under either executor and a
    pipeline tail."""
    return mesh if isinstance(mesh, DistTileMesh) else None


def _global_sum(dmesh: DistTileMesh, s: torch.Tensor, cnt: float,
                kept: dict) -> tuple[torch.Tensor, float]:
    """A rank's loss sum and count summed over the ranks, in one all-reduce
    (float64), detached: the sum in its own dtype, the count a float.

    The count is the plan's geometry, the same at every step of one batch
    size, and the step divides by it as a host float.  An eager step reads
    it back into ``kept`` (the caller's, one per step function); a step
    being captured as a CUDA graph, which cannot read the device, takes the
    kept one, which the eager warm steps before a capture made."""
    tot = all_reduce_(dmesh.group, [torch.stack([
        s.detach().double(), torch.full((), float(cnt), dtype=torch.float64, device=s.device)])])[0]
    if not (s.is_cuda and torch.cuda.is_current_stream_capturing()):
        kept[float(cnt)] = float(tot[1])
    elif float(cnt) not in kept:
        raise RuntimeError("a step captured on ranks needs an eager step of the same batch "
                           "first: the ranks' summed count is read back outside the graph")
    return tot[0].to(s.dtype), kept[float(cnt)]


def _stateless_wire(plan: StackPlan) -> WireCtx | None:
    """Wire ctx for the paths with no EF carry (the single-shot forward and
    loss, the pipeline tick): residuals are fresh zeros, so compression is
    stateless.  ``None`` for codec=none - every call site then runs
    today's uncompressed code."""
    codec = get_codec(plan.wire_codec)
    return None if codec is None else WireCtx(codec, EFBag("stateless"))


def make_tiled_forward(plan: StackPlan, mesh: TileMesh):
    """Forward over the virtual mesh: ``(params, x_global) -> y_global``.

    ``x_global`` (B, H, W, C) is split into the n x m tiles and run through
    ``apply_stack_local`` (one kernel launch per conv call for all tiles);
    the global output is assembled from the plan's output layout
    (``_out_spec``): row-major tiles, or a hybrid plan's batch blocks in
    block order, so either way it is (B, OH, OW, C) in input order.  A
    ragged plan packs the input into its padded tiles and unpacks each
    output tile's valid window.  A codec plan compresses its strips
    statelessly (``_stateless_wire``).  On ranks each runs its block and
    the output - its tiles, or a hybrid plan's batch blocks - is gathered
    on every rank (not differentiated)."""
    dmesh = _dist_of(mesh)
    if plan.stages:
        raise ValueError(
            "pipeline plans have no single-shot forward layout: outputs "
            "live on the last stage's devices only, one microbatch per "
            "tick; use make_tiled_loss / make_deferred_grad_step (or a "
            "non-pipeline plan for inference)"
        )
    if (mesh.n, mesh.m) != (plan.n, plan.m):
        raise ValueError(f"mesh grid {(mesh.n, mesh.m)} != plan grid {(plan.n, plan.m)}")
    split = _in_split(plan, mesh)
    _, merge = _out_spec(plan, mesh)
    wire = _stateless_wire(plan)

    def fwd(params, x):
        x = torch.as_tensor(x, device=mesh.device)
        if x.dim() != 4 or tuple(x.shape[1:3]) != plan.input_hw:
            raise ValueError(
                f"input {tuple(x.shape)} does not match the plan's (B, "
                f"{plan.input_hw[0]}, {plan.input_hw[1]}, C)"
            )
        _check_data_batch(plan, x.shape[0])
        with tile_mesh_ctx(dmesh):
            y = apply_stack_local(params, split(x), plan, wire)
        return merge(y)

    return fwd


def _check_not_inference(plan: StackPlan, what: str) -> None:
    if plan.inference:
        raise ValueError(
            f"{what} is a training entry point, but the plan is forward-only "
            "(inference=True): training BN needs cross-tile batch statistics "
            "the serve executor deliberately does not take; build a training "
            "plan (inference=False) instead"
        )


def make_tiled_loss(plan: StackPlan, mesh: TileMesh, loss_local):
    """Scalar loss over the *global* output map: ``(params, x, target) ->
    loss`` with x (B, H, W, C) and target (B, OH, OW, Cout).

    ``loss_local(y, t) -> (sum, count)`` sees all tiles at once, as
    ``(n, m, B, h, w, C)`` tensors, so its sum and count already are the
    reference's psums over the tiles: ``loss = sum_tiles s / sum_tiles c``,
    the untiled loss exactly.  After a crossover the target is split into
    the executor's batch blocks (``_out_spec``), as the reference binds it
    with its data-side out-spec.  A ragged plan's loss is exact too: a spec
    plan scores each output tile's true core (``_spec_core_loss``), a
    padded plan its zero-padded tiles with the count rescaled
    (``_ragged_count_scale``).  Autograd through it gives the paper's tiled
    backward pass.  A pipeline plan runs the tick executor with M=1 (the
    batch streams through the stages once) and the last stage scores its
    tiles' rank blocks: the untiled loss again; the returned function's
    ``census`` holds the last call's slot counts.  A codec plan compresses
    its strips statelessly: every call starts from zero residuals.

    On ranks each rank scores its block: the value is the global loss on
    every rank (the sums and counts all-reduced, detached), and its
    gradient is the rank's own sum's, with every param ``replicated`` so
    that the backward sums the ranks' gradients into the global one."""
    _check_not_inference(plan, "make_tiled_loss")
    dmesh = _dist_of(mesh)
    if plan.stages:
        run = _make_pipeline_local(plan, mesh, loss_local, microbatches=1)
        counts: dict = {}

        def ploss(params, x, target):
            x = torch.as_tensor(x, device=mesh.device)
            _check_pipeline_batch(plan, x.shape[0])
            t = torch.as_tensor(target, device=mesh.device)
            leaves = [v for p in params for v in p.values()]
            if dmesh is not None:
                leaves = [replicated(v, dmesh.group) for v in leaves]
            s = _PipelineLoss.apply(run, x[None], t[None], params, *leaves)
            ploss.census = run.census
            if dmesh is None:
                return s / run.count
            s_all, c_all = _global_sum(dmesh, s, run.count, counts)
            return (s_all + (s - s.detach())) / c_all

        ploss.census = None
        return ploss
    split = _in_split(plan, mesh)
    tiles_loss = _tiles_loss(plan, mesh, loss_local)
    wire = _stateless_wire(plan)
    counts: dict = {}

    def loss(params, x, target):
        x = torch.as_tensor(x, device=mesh.device)
        _check_data_batch(plan, x.shape[0])
        if dmesh is None:
            s, c = tiles_loss(apply_stack_local(params, split(x), plan, wire), target)
            return s / c
        params = [{k: replicated(v, dmesh.group) for k, v in p.items()} for p in params]
        with tile_mesh_ctx(dmesh):
            s, c = tiles_loss(apply_stack_local(params, split(x), plan, wire), target)
        s_all, c_all = _global_sum(dmesh, s, c, counts)
        # the value is the global sum's on every rank, bit for bit; the
        # gradient is this rank's own sum's
        return (s_all + (s - s.detach())) / c_all

    return loss


def make_deferred_grad_step(
    plan: StackPlan,
    mesh: TileMesh,
    loss_local,
    *,
    microbatches: int = 1,
):
    """Paper §4.1 deferred weight aggregation: ``(params, xs, ts) ->
    (loss_mean, grads)`` with xs (microbatches, b, H, W, C) and ts
    (microbatches, b, OH, OW, Cout).  ``grads`` mirrors ``params`` (a list
    of per-layer dicts).

    A Python loop over the microbatches accumulates each one's weight
    gradients (in place into the first one's, to hold one copy), and ONE
    division by the global count at batch end gives the final gradients -
    the reference's scan followed by its single psum.  After a crossover
    each microbatch's target is split into the executor's batch blocks
    (``_out_spec``), and autograd runs the adjoint reshard inside each
    microbatch.  The cross-tile sum
    of the weight gradients needs no separate step on the virtual mesh: the
    tiles are the batch dimension of every conv, so wgrad (B3 on the card)
    sums the per-tile partials inside its own reduction.  On ranks B3 sums
    the block's tiles, and the accumulated gradients, the loss sum and the
    count are all-reduced once after the microbatch loop, before the one
    division; each rank differentiates its own loss sum (the seed is
    replicated, so a sum reduced ahead of the backward would count every
    gradient W times).  Ragged plans score each microbatch as
    ``make_tiled_loss`` does.

    A pipeline plan takes ``microbatches`` as the pipeline depth M: one
    walk of the tick schedule streams all M microbatches through the
    stages and one reverse walk carries the cotangents back through the
    reverse hand-offs (``_make_pipeline_local``), then the gradients (on
    ranks: all-reduced with the loss sum and count) take the one division
    by the global count; the trainer tail, int8-EF included, is the same.
    It holds all M microbatches' activations at once, and compresses a
    codec plan's strips statelessly.
    The returned function's ``census`` holds the last call's slot counts.

    A codec plan (DESIGN.md §12) carries error feedback across the
    microbatches of one batch: every exchange's backward strip is quantised
    against its own residual, which starts at zero each step.  The first
    microbatch finds the carry's layout as it runs (an ``EFBag`` in
    ``collect`` mode hands out zeros); each new residual comes back as the
    gradient of the residual the exchange drew, and the next microbatch's
    bag (``buffers`` mode) hands them out in the same order."""
    _check_not_inference(plan, "make_deferred_grad_step")
    dmesh = _dist_of(mesh)
    if plan.stages:
        return _pipeline_grad_step(plan, mesh, loss_local, microbatches)
    split = _in_split(plan, mesh)
    tiles_loss = _tiles_loss(plan, mesh, loss_local)
    codec = get_codec(plan.wire_codec)
    counts: dict = {}

    def step(params, xs, ts):
        xs = torch.as_tensor(xs, device=mesh.device)
        ts = torch.as_tensor(ts, device=mesh.device)
        if xs.shape[0] != microbatches or ts.shape[0] != microbatches:
            raise ValueError(
                f"grad step built for microbatches={microbatches}; got "
                f"{xs.shape[0]} input and {ts.shape[0]} target microbatches"
            )
        _check_data_batch(plan, xs.shape[1])
        live = [{k: v.detach().requires_grad_(True) for k, v in p.items()} for p in params]
        leaves = [v for p in live for v in p.values()]
        acc = None
        loss_sum = cnt = 0.0
        ef = None
        for i in range(microbatches):
            wire = bag = None
            if codec is not None:
                bag = EFBag("collect") if ef is None else EFBag("buffers", ef)
                wire = WireCtx(codec, bag)
            with tile_mesh_ctx(dmesh):
                s, c = tiles_loss(apply_stack_local(live, split(xs[i]), plan, wire), ts[i])
            if bag is None:
                g = torch.autograd.grad(s, leaves, allow_unused=True)
            else:
                res = bag.drawn if ef is None else ef
                g = torch.autograd.grad(s, leaves + res, allow_unused=True)
                ef = [(torch.zeros_like(r) if gr is None else gr).detach().requires_grad_(True)
                      for r, gr in zip(res, g[len(leaves):])]
                g = g[:len(leaves)]
            g = [torch.zeros_like(v) if gi is None else gi for v, gi in zip(leaves, g)]
            if acc is None:
                acc = g
            else:
                for a, gi in zip(acc, g):
                    a.add_(gi)
            loss_sum = loss_sum + s.detach()
            cnt = cnt + c
        if dmesh is not None:
            acc = all_reduce_(dmesh.group, acc)
            loss_sum, cnt = _global_sum(dmesh, loss_sum, cnt, counts)
        it = iter(a / cnt for a in acc)
        grads = [{k: next(it) for k in p} for p in live]
        return loss_sum / cnt, grads

    return step


def _pipeline_grad_step(plan: StackPlan, mesh: TileMesh, loss_local, microbatches: int):
    run = _make_pipeline_local(plan, mesh, loss_local, microbatches=microbatches)
    dmesh = run.dmesh
    counts: dict = {}

    def pstep(params, xs, ts):
        xs = torch.as_tensor(xs, device=mesh.device)
        ts = torch.as_tensor(ts, device=mesh.device)
        if xs.shape[0] != microbatches or ts.shape[0] != microbatches:
            raise ValueError(
                f"pipeline grad step built for microbatches={microbatches}; got "
                f"{xs.shape[0]} input and {ts.shape[0]} target microbatches"
            )
        _check_pipeline_batch(plan, xs.shape[1])
        live = [{k: v.detach().requires_grad_(True) for k, v in p.items()} for p in params]
        leaves = [v for p in live for v in p.values()]
        with tile_mesh_ctx(dmesh):
            st = run.forward(leaves, live, xs, ts, grad=True)
            g = run.backward(st, 1.0)
        pstep.census = run.census
        g = [torch.zeros_like(v) if gi is None else gi for v, gi in zip(leaves, g)]
        s, c = st["s"].detach(), st["c"]
        if dmesh is not None:
            g = all_reduce_(dmesh.group, g)
            s, c = _global_sum(dmesh, s, c, counts)
        it = iter(gi / c for gi in g)
        return s / c, [{k: next(it) for k in p} for p in live]

    pstep.census = None
    return pstep


def make_tiled_infer(plan: StackPlan, mesh: TileMesh):
    """The serve step: ``make_tiled_forward`` of a forward-only plan, run
    under ``torch.inference_mode``.  Training plans are refused, so the
    train/serve BN semantics stay an explicit plan-time choice."""
    if not plan.inference:
        raise ValueError(
            "make_tiled_infer needs a forward-only plan: build with "
            "build_stack_plan(..., inference=True) or take "
            "plan.inference_twin(); training plans use batch BN statistics"
        )
    fwd = make_tiled_forward(plan, mesh)

    def infer(params, x):
        with torch.inference_mode():
            return fwd(params, x)

    return infer


def reference_forward(params, x, plan: StackPlan):
    return stack_reference(x, params, plan.layers, inference=plan.inference)


def reference_loss(params, x, target, plan: StackPlan, loss_local):
    """The untiled loss: ``reference_forward`` then ``loss_local`` over the
    whole map."""
    y = reference_forward(params, x, plan)
    s, c = loss_local(y, target)
    return s / c
