"""Grouping cost model + optimizer (paper §3/§5.3/§5.4 and tech report [21]).

Grouping trades redundant halo compute against communication/synchronisation
frequency.  The optimum depends on the hardware ratio of compute rate to link
bandwidth/latency: the paper measures no-grouping optimal on compute-bound
Raspberry Pis (Fig. 7) and grouping optimal on comm-bound Jetson GPUs
(Fig. 8).  This module provides the analytic cost model over a hardware
profile and a DP optimizer for the grouping profile, and ships profiles for
the paper's two testbeds plus the TPU-v5e target.

Cost of one training cycle (batch of ``batch`` samples) under profile hw for
a grouping (s..e are inclusive layer ranges; each group carries a partition
``mode``, DESIGN.md §7):

  spatial groups (the paper's tiling/fusing regime):
    compute   3x forward MACs over *extended* (halo-grown) tiles / hw.flops
              (fwd + delta backprop + weight grad each ~= the fwd MACs; §4.1)
    boundary  2x per-group-input halo bytes / hw.link_bw (fwd + bwd)
    sync      2x hw.sync_latency per group boundary
  data groups (batch split over the same devices, full maps):
    compute   3x forward MACs / (n*m) / hw.flops - exact, no halo redundancy
    (no boundary, no sync: a data-mode layer exchanges no activations)
  reshard   once per sample per direction at the spatial->data crossover:
            the all-gather of the tile grid into full maps (fwd) and its
            adjoint reduce-scatter (bwd), (T-1)/T of the map bytes each
  weights   once per batch: ring all-reduce of the *replicated* filter
            bytes - the data-mode tail under a hybrid plan, the full stack
            under a pure-spatial plan (see ``profile_cost``)

All per-sample terms scale with batch except the weight aggregation -
exactly the paper's Fig. 7 observation that larger batches favour finer
grouping on the Pis - and the crossover trades the tail's halo+sync for
the one-time reshard plus the tail's weight-aggregation charge.

The port of ``repro/core/grouping.py``: plain Python over the port's own
``LayerDef``, ``Group``, ``TilePartition`` and tiling helpers, with the
reference's names, constants and order of arithmetic, so every cost comes
out bit-identical (``tests/test_torch_grouping.py``).  The stage, wire and
device-list functions are here because ``profile_cost`` and
``optimize_grouping`` reach them; the pipeline executor and the elastic
replan (``replan_stack``) are in ``core/fusion.py``, the wire codecs in
``core/halo.py`` and ``optim/compression.py``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Sequence

from repro_torch.core.spatial import LayerDef, split_1d
from repro_torch.optim.compression import modeled_wire_bytes
from repro_torch.core.tiling import (
    Group,
    TilePartition,
    bounds_sizes,
    crossover_of,
    derive_axis_bounds,
    even_bounds_1d,
    pipeline_first_of,
    pull_bounds_1d,
)

SCHEDULES = ("sync", "overlap")

#: Microbatch count the pipeline cost terms assume when the caller does not
#: say (DESIGN.md §11): the bubble fraction (S-1)/(S-1+M) needs M at *plan*
#: time, while the executor takes the true M (``grad_accum``) at trace time.
#: Planner callers that know their accumulation depth should pass it.
PIPELINE_MICROBATCHES = 8

#: MAC-equivalents charged per pad-slot element the shape-specialized
#: executor repads each layer output with (one read + one write, forward and
#: backward roughly cancelling against the copy's streaming nature).  The
#: specialization overhead term in ``_group_cost_cluster`` (DESIGN.md §9):
#: skewed partitions make every device rewrite its output into the canonical
#: (max-tile) extent, so the modeled makespan no longer pretends extreme
#: skews are free - the balancer's objective is unchanged, but grouping/
#: crossover scoring sees the executor's real padding bill.
SPEC_PAD_MACS = 2.0

#: MAC-equivalents charged per element for a wire codec's quantize +
#: dequantize passes (abs-max scan, round, rescale - a few streaming ops on
#: each side of the link).  Every compressed comm term adds
#: ``2 * elems * QDQ_MACS / flops`` (encode the send + decode the receive)
#: next to its byte term, so a codec is never modeled as free: on fat links
#: the QDQ tax exceeds the byte savings and the planner correctly leaves
#: the wire uncompressed.
QDQ_MACS = 8.0


def _hw_flops(hw: "HardwareProfile | ClusterSpec") -> float:
    """Per-device MAC rate the QDQ compute charge is priced at - the
    conservative (slowest-device) scalar for clusters, matching the other
    plan-level collective terms."""
    return hw.min_flops if isinstance(hw, ClusterSpec) else hw.flops


def _xfer_seconds(
    n_elems: float, dtype_bytes: int, bw: float, flops: float, wire_codec: str
) -> float:
    """Seconds to push ``n_elems`` across a ``bw``-byte/s link under
    ``wire_codec``: compressed wire bytes (``modeled_wire_bytes``) plus the
    encode/decode compute at ``flops``.  The single routine every comm term
    (halo boundary, reshard, weight aggregation, pipeline hand-off) prices
    bytes through, so the codec discount can never apply to one wire and
    not another.  The ``"none"`` branch reproduces the legacy expression
    exactly - codec-free plans cost (and therefore plan) identically to
    pre-codec builds."""
    if wire_codec == "none":
        return n_elems * dtype_bytes / bw
    return (
        modeled_wire_bytes(n_elems, dtype_bytes, wire_codec) / bw
        + 2.0 * n_elems * QDQ_MACS / flops
    )


def _check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}; got {schedule!r}")


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    flops: float          # sustained MAC/s *per tile executor* (2 MAC = 1 FLOP pair)
    link_bw: float        # bytes/s per link for boundary exchange
    sync_latency: float   # seconds per synchronisation round
    agg_bw: float         # bytes/s for the weight all-reduce
    dtype_bytes: int = 4


# The paper's testbeds (order-of-magnitude; calibrated so the measured
# regimes reproduce: Pi => no grouping, Jetson => grouping).
PI3_PROFILE = HardwareProfile(
    name="pi3-core",
    flops=0.0435e9,           # one Cortex-A53 core running darknet's naive
                              # GEMM; calibrated so 1 tile x 1 sample takes
                              # ~7 min on YOLOv2-16 (paper S5.1, Fig. 5)
    link_bw=12.5e6 / 4,       # 100 Mbps Ethernet shared by 4 tile processes
    sync_latency=2e-3,        # TCP round + process sync
    agg_bw=12.5e6,
)

JETSON_PROFILE = HardwareProfile(
    name="jetson-nano-gpu",
    flops=235e9,              # Maxwell 128-core GPU, fp32 MAC/s
    link_bw=1.25e9,           # 10 Gbps Ethernet
    sync_latency=5e-3,        # kernel launch + D2H/H2D + TCP round
    agg_bw=1.25e9,
)

# The comm-bound extrapolation the hybrid planner targets (DESIGN.md §7):
# the Jetson pair on the same shared 100 Mbps Ethernet as the Pi cluster.
# GPU-rate compute against a Pi-rate network makes the weight-dominated
# tail's halo+sync untenable while the feature-dominated front still
# amortises - ``crossover="auto"`` selects a mid-stack spatial->data
# crossover here (asserted in tests), where the stock gigabit Jetson
# profile flips all the way to data and the Pi profile to none.
JETSON_EDGE_PROFILE = HardwareProfile(
    name="jetson-edge-100m",
    flops=235e9,
    link_bw=12.5e6,
    sync_latency=5e-3,
    agg_bw=12.5e6,
)

TPU_V5E_PROFILE = HardwareProfile(
    name="tpu-v5e-chip",
    flops=98.5e12,            # 197 TFLOP/s bf16 = 98.5e12 MAC/s
    link_bw=50e9,             # ICI per link
    sync_latency=2e-6,        # ICI collective launch
    agg_bw=50e9,
    dtype_bytes=2,
)

PROFILES = {
    p.name: p
    for p in (PI3_PROFILE, JETSON_PROFILE, JETSON_EDGE_PROFILE, TPU_V5E_PROFILE)
}


# ---------------------------------------------------------------------------
# Heterogeneous clusters: per-device profiles + makespan-balanced partitions
# (DESIGN.md §8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """An n x m tile grid of per-device ``HardwareProfile``s.

    The paper's cluster is homogeneous (equal Pi cores => equal tiles); real
    edge deployments mix device classes (DistrEdge, arXiv:2202.01699).  A
    ClusterSpec drives both the makespan-balancing partitioner
    (``cluster_partition``: tile area ∝ device FLOPs) and the cost model's
    max-over-devices makespan terms (each device's time from *its* tile and
    *its* link, the slowest device bounding the cycle)."""

    name: str
    grid: tuple[tuple[HardwareProfile, ...], ...]

    def __post_init__(self):
        if not self.grid or any(len(r) != len(self.grid[0]) for r in self.grid):
            raise ValueError(f"cluster grid must be rectangular; got {self.grid}")

    @property
    def n(self) -> int:
        return len(self.grid)

    @property
    def m(self) -> int:
        return len(self.grid[0])

    @property
    def devices(self) -> tuple[HardwareProfile, ...]:
        return tuple(p for row in self.grid for p in row)

    @property
    def is_uniform(self) -> bool:
        return len(set(self.devices)) == 1

    @property
    def dtype_bytes(self) -> int:
        return max(p.dtype_bytes for p in self.devices)

    @property
    def min_flops(self) -> float:
        return min(p.flops for p in self.devices)

    @property
    def min_link_bw(self) -> float:
        return min(p.link_bw for p in self.devices)

    @property
    def min_agg_bw(self) -> float:
        return min(p.agg_bw for p in self.devices)

    @property
    def max_sync_latency(self) -> float:
        return max(p.sync_latency for p in self.devices)

    # Conservative scalar views so plan-level terms (reshard, weight
    # aggregation) that read a single profile's fields work on clusters
    # unchanged: a collective is paced by the slowest link / latest arriver.
    @property
    def link_bw(self) -> float:
        return self.min_link_bw

    @property
    def agg_bw(self) -> float:
        return self.min_agg_bw

    @property
    def sync_latency(self) -> float:
        return self.max_sync_latency

    @property
    def flops(self) -> float:
        return self.min_flops


#: Short spellings accepted by ``parse_cluster_spec`` (full registered
#: profile names work too).
CLUSTER_ALIASES = {
    "pi3": PI3_PROFILE,
    "jetson": JETSON_PROFILE,
    "jetson-edge": JETSON_EDGE_PROFILE,
    "tpu": TPU_V5E_PROFILE,
    **PROFILES,
}

_SPEC_PART = re.compile(r"^(.+?)(?:x(\d+))?$")


def parse_cluster_spec(spec: str, n: int, m: int) -> ClusterSpec:
    """``"pi3x3+jetson"`` -> 3 Pi tiles + 1 Jetson filling an n x m grid
    row-major.  Each '+'-separated part is ``<profile>[x<count>]`` with
    profile an alias or registered name; counts must sum to n*m."""
    devs: list[HardwareProfile] = []
    for part in spec.split("+"):
        mt = _SPEC_PART.match(part.strip())
        name, cnt = (mt.group(1), mt.group(2)) if mt else (part, None)
        if name not in CLUSTER_ALIASES:
            raise ValueError(
                f"unknown device {name!r} in cluster spec {spec!r}; "
                f"known: {sorted(set(CLUSTER_ALIASES))}"
            )
        devs.extend([CLUSTER_ALIASES[name]] * (int(cnt) if cnt else 1))
    if len(devs) != n * m:
        raise ValueError(
            f"cluster spec {spec!r} names {len(devs)} devices; grid {n}x{m} "
            f"needs {n * m}"
        )
    grid = tuple(tuple(devs[i * m : (i + 1) * m]) for i in range(n))
    return ClusterSpec(name=spec, grid=grid)


def _best_grid(k: int) -> tuple[int, int]:
    """Most-square (n, m) factorisation of k with n <= m - the grid shape
    survivors are re-packed into after an elastic membership change.  Square
    grids minimise the halo perimeter per tile; prime counts degrade to a
    1 x k strip (still a valid tile grid)."""
    best = (1, k)
    for n in range(2, int(k ** 0.5) + 1):
        if k % n == 0:
            best = (n, k // n)
    return best


def pack_devices(name: str, devices: Sequence[HardwareProfile]) -> ClusterSpec:
    """Re-pack a flat device list row-major into the most-square grid that
    holds it (elastic replan: the surviving devices of a cluster whose grid
    shape no longer exists)."""
    if not devices:
        raise ValueError("cannot build a cluster from zero devices")
    n, m = _best_grid(len(devices))
    grid = tuple(tuple(devices[i * m : (i + 1) * m]) for i in range(n))
    return ClusterSpec(name=name, grid=grid)


def _device_index(cluster: ClusterSpec, device: str | int) -> int:
    """Flat row-major index of ``device`` in the cluster grid: an int is
    taken verbatim; a string matches a profile name or cluster alias
    (first match row-major)."""
    devs = cluster.devices
    if isinstance(device, int):
        if not 0 <= device < len(devs):
            raise ValueError(
                f"device index {device} out of range for {len(devs)}-device "
                f"cluster {cluster.name!r}"
            )
        return device
    target = CLUSTER_ALIASES.get(device)
    for i, p in enumerate(devs):
        if p.name == device or (target is not None and p == target):
            return i
    raise ValueError(
        f"no device {device!r} in cluster {cluster.name!r}; devices: "
        f"{[p.name for p in devs]}"
    )


def drop_device(cluster: ClusterSpec, device: str | int) -> ClusterSpec:
    """Surviving cluster after ``device`` disappears (battery death,
    network drop): remove it and re-pack the rest into the most-square
    grid.  The elastic replan path feeds this straight into
    ``fusion.replan_stack`` - losing the Jetson of ``pi3x3+jetson`` leaves
    a 1x3 all-Pi cluster whose partition re-balances to (near-)even."""
    idx = _device_index(cluster, device)
    devs = list(cluster.devices)
    if len(devs) == 1:
        raise ValueError(
            f"cannot drop the last device of cluster {cluster.name!r}"
        )
    name = devs[idx].name
    del devs[idx]
    return pack_devices(f"{cluster.name}-{name}", devs)


def add_device(cluster: ClusterSpec, device: str | HardwareProfile) -> ClusterSpec:
    """Cluster after a device joins (elastic scale-up): append and re-pack
    into the most-square grid."""
    if isinstance(device, str):
        if device not in CLUSTER_ALIASES:
            raise ValueError(
                f"unknown device {device!r}; known: {sorted(set(CLUSTER_ALIASES))}"
            )
        device = CLUSTER_ALIASES[device]
    devs = list(cluster.devices) + [device]
    return pack_devices(f"{cluster.name}+{device.name}", devs)


def profile_manifest(p: HardwareProfile) -> dict:
    return dataclasses.asdict(p)


def profile_from_manifest(d: dict) -> HardwareProfile:
    return HardwareProfile(**d)


def cluster_manifest(cluster: ClusterSpec) -> dict:
    """JSON form of a ClusterSpec for the checkpoint plan manifest.  Full
    profile fields per grid cell (not just names) so ad-hoc profiles
    round-trip without a registry lookup."""
    return {
        "name": cluster.name,
        "grid": [[profile_manifest(p) for p in row] for row in cluster.grid],
    }


def cluster_from_manifest(d: dict) -> ClusterSpec:
    return ClusterSpec(
        name=d["name"],
        grid=tuple(
            tuple(profile_from_manifest(p) for p in row) for row in d["grid"]
        ),
    )


def _bounds_makespan(
    row_bounds: Sequence[int], col_bounds: Sequence[int], flops
) -> float:
    """max over devices of tile_area / device_flops - the work-balance
    objective the partitioner minimises (a per-layer-area proxy: every
    layer's tile area scales with the same fractions)."""
    rs = [hi - lo for lo, hi in zip(row_bounds, row_bounds[1:])]
    cs = [hi - lo for lo, hi in zip(col_bounds, col_bounds[1:])]
    return max(
        rs[i] * cs[j] / flops[i][j] for i in range(len(rs)) for j in range(len(cs))
    )


def _bounds_of(sizes: Sequence[int]) -> list[int]:
    out = [0]
    for s in sizes:
        out.append(out[-1] + s)
    return out


def _waterfill(weights: Sequence[float], total: int, floor: int = 1) -> list[int]:
    """Integer sizes >= ``floor`` summing to ``total``, ~proportional to
    1/weight (minimising max_k weight_k * size_k), fixed up greedily."""
    inv = [1.0 / w for w in weights]
    s = sum(inv)
    sizes = [max(floor, round(total * v / s)) for v in inv]
    while sum(sizes) > total:
        k = min(
            (k for k in range(len(sizes)) if sizes[k] > floor),
            key=lambda k: weights[k] * (sizes[k] - 1),
        )
        sizes[k] -= 1
    while sum(sizes) < total:
        k = min(range(len(sizes)), key=lambda k: weights[k] * (sizes[k] + 1))
        sizes[k] += 1
    return sizes


def balance_bounds(
    extent_hw: tuple[int, int], cluster: ClusterSpec, *, min_size: int = 1
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """FLOPs-proportional boundary arrays at one map extent, minimising
    ``max_ij area_ij / flops_ij`` (every layer's tile area scales with the
    same fractions, so one extent-level balance serves the whole stack).

    Pure single-boundary descent stalls on the even split (a 2x2 mixed grid
    needs a row and a column boundary to move *together*), so this runs
    alternating per-axis water-filling - for fixed rows, the optimal integer
    column sizes are ∝ 1 / max_i(row_i / flops_ij) - from several starts
    (even + FLOPs-marginal), polishes with greedy ±1 moves, and keeps the
    best.  The even split is always a candidate, so the result is never
    worse than uniform tiling; tests brute-force small grids to confirm it
    beats uniform whenever device FLOPs differ.

    ``min_size``: per-tile extent floor (clamped to the even share per
    axis).  ``cluster_partition`` passes the per-layer halo floor
    (``_min_extent_floor``) so the balancer never proposes a sliver the
    halo exchange cannot feed or the shape-specialized executor cannot
    win on (DESIGN.md §9)."""
    h, w = extent_hw
    n, m = cluster.n, cluster.m
    floors = (max(1, min(min_size, h // n)), max(1, min(min_size, w // m)))
    flops = [[p.flops for p in row] for row in cluster.grid]
    even = (list(even_bounds_1d(h, n)), list(even_bounds_1d(w, m)))
    if cluster.is_uniform:
        return tuple(even[0]), tuple(even[1])

    def col_weights(rs):
        return [max(rs[i] / flops[i][j] for i in range(n)) for j in range(m)]

    def row_weights(cs):
        return [max(cs[j] / flops[i][j] for j in range(m)) for i in range(n)]

    def alternate(rs, cs):
        for _ in range(32):
            cs2 = _waterfill(col_weights(rs), w, floors[1])
            rs2 = _waterfill(row_weights(cs2), h, floors[0])
            if rs2 == rs and cs2 == cs:
                break
            rs, cs = rs2, cs2
        return rs, cs

    starts = [(list(bounds_sizes(even[0])), list(bounds_sizes(even[1])))]
    row_marg = [sum(flops[i]) for i in range(n)]
    col_marg = [sum(flops[i][j] for i in range(n)) for j in range(m)]
    starts.append(
        (
            _waterfill([1.0 / f for f in row_marg], h, floors[0]),
            _waterfill([1.0 / f for f in col_marg], w, floors[1]),
        )
    )
    cands = [even]
    for rs0, cs0 in starts:
        rs, cs = alternate(list(rs0), list(cs0))
        cands.append((_bounds_of(rs), _bounds_of(cs)))

    def polish(rb, cb):
        # Greedy descent over single-boundary moves AND paired (row, col)
        # moves: the makespan is flat against any single move at symmetric
        # points (shrinking one side of a slow tile grows its neighbour),
        # so escaping them needs a row and a column boundary stepping
        # together.
        moves = [[(br, k, d)] for br in (0, 1) for k in range(1, (n, m)[br]) for d in (1, -1)]
        moves += [
            [(0, kr, dr), (1, kc, dc)]
            for kr in range(1, n) for kc in range(1, m)
            for dr in (1, -1) for dc in (1, -1)
        ]
        bounds = (rb, cb)
        best = _bounds_makespan(rb, cb, flops)
        improved = True
        while improved:
            improved = False
            for mv in moves:
                while True:
                    ok = all(
                        bounds[br][k] + d - bounds[br][k - 1] >= floors[br]
                        and bounds[br][k + 1] - (bounds[br][k] + d) >= floors[br]
                        for br, k, d in mv
                    )
                    if not ok:
                        break
                    for br, k, d in mv:
                        bounds[br][k] += d
                    cost = _bounds_makespan(rb, cb, flops)
                    if cost < best - 1e-15:
                        best = cost
                        improved = True
                    else:
                        for br, k, d in mv:
                            bounds[br][k] -= d
                        break
        return best

    scored = []
    for rb, cb in cands:
        rb, cb = list(rb), list(cb)
        scored.append((polish(rb, cb), rb, cb))
    _, rb, cb = min(scored, key=lambda t: t[0])
    return tuple(rb), tuple(cb)


def _min_extent_floor(layers: Sequence[LayerDef], last: int) -> int:
    """Smallest per-tile extent at the balanced (deepest spatially-sharded)
    layer that keeps every earlier layer's tile at least as wide as its own
    per-layer halo.  A tile owning z rows at the balance extent owns
    ``z * prod(strides[l:last])`` rows at layer l's input, which must cover
    ``max(halo_lo, halo_hi)`` of that layer - otherwise the exchange cannot
    feed the tile (the plan-time "halo exceeds the smallest tile" error)
    and the shape-specialized executor cannot win on it (DESIGN.md §9)."""
    floor = 1
    sprod = 1
    for l in range(last - 1, -1, -1):
        sprod *= layers[l].stride
        lo, hi = layers[l].halo
        floor = max(floor, -(-max(lo, hi) // sprod))
    return floor


def cluster_partition(
    input_hw: tuple[int, int],
    layers: Sequence[LayerDef],
    cluster: ClusterSpec,
    cross: int | None = None,
) -> TilePartition:
    """Makespan-balanced input-level partition for a heterogeneous cluster:
    balance the boundaries at the last spatially-sharded extent (the
    crossover input, or the stack output) - under the per-layer halo floor
    (``_min_extent_floor``) - then pull them back through the strides so
    every layer's boundaries stay stride-aligned."""
    ext = _map_extents(input_hw, layers)
    last = len(layers) if cross is None else cross
    rb, cb = balance_bounds(
        ext[last], cluster, min_size=_min_extent_floor(layers, last)
    )
    for l in range(last - 1, -1, -1):
        rb = pull_bounds_1d(rb, layers[l].stride, ext[l][0])
        cb = pull_bounds_1d(cb, layers[l].stride, ext[l][1])
    return TilePartition(rb, cb)


def _layer_tiles(
    input_hw: tuple[int, int],
    layers: Sequence[LayerDef],
    n: int,
    m: int,
    partition: TilePartition | None,
    cross: int | None = None,
):
    """(row_sizes, col_sizes) per layer extent 0..last for the cost model:
    per-tile owned extents under ``partition`` (or the stride-aligned
    ragged-even default)."""
    ext = _map_extents(input_hw, layers)
    last = len(layers) if cross is None else cross
    strides = [l.stride for l in layers[:last]]
    rb = derive_axis_bounds(
        partition.row_bounds if partition else None, strides,
        [e[0] for e in ext[: last + 1]], n,
    )
    cb = derive_axis_bounds(
        partition.col_bounds if partition else None, strides,
        [e[1] for e in ext[: last + 1]], m,
    )
    return [bounds_sizes(b) for b in rb], [bounds_sizes(b) for b in cb]


# ---------------------------------------------------------------------------
# Geometry helpers (cost-model view: interior tile, both-side halos)
# ---------------------------------------------------------------------------


def _map_extents(input_hw: tuple[int, int], layers: Sequence[LayerDef]):
    ext = [tuple(input_hw)]
    for l in layers:
        h, w = ext[-1]
        ext.append((l.out_extent(h), l.out_extent(w)))
    return ext


def _halo_widths(layers: Sequence[LayerDef], s: int, e: int) -> tuple[list[int], list[int]]:
    """Eq. (1) backward recursion: both-side halo widths at the input of
    each layer of group [s, e] (index k = layer s+k; entry e-s+1 = group
    output, zero).  Shared by the cost model and the memory estimator so
    the two can never desynchronise."""
    halo_lo = [0] * (e - s + 2)
    halo_hi = [0] * (e - s + 2)
    for idx in range(e, s - 1, -1):
        l = layers[idx]
        p, q = l.padding, l.kernel - l.stride - l.padding
        k = idx - s
        halo_lo[k] = halo_lo[k + 1] * l.stride + p
        halo_hi[k] = halo_hi[k + 1] * l.stride + q
    return halo_lo, halo_hi


def _group_cost(
    layers: Sequence[LayerDef],
    ext: Sequence[tuple[int, int]],
    s: int,
    e: int,
    n: int,
    m: int,
    hw: HardwareProfile,
    batch: int,
    schedule: str = "sync",
    mode: str = "spatial",
    wire_codec: str = "none",
) -> tuple[float, float, float, float]:
    """(compute_s, boundary_s, sync_s, hidden_s) for group [s, e] per cycle.

    hidden_s is the boundary-transfer time hidden under the group-lead
    layer's *interior* compute when ``schedule="overlap"`` (DESIGN.md §5):
    the interior region depends only on owned data, so its MACs run
    concurrently with the halo collectives - ``min(boundary_s,
    interior_compute_s)`` of the transfer disappears from the critical
    path.  Zero under the sync schedule.

    ``mode="data"``: the batch is split over the n*m devices and every
    device holds full maps, so boundary/sync/hidden are all zero - a
    data-mode layer exchanges no activations (its costs live in the
    plan-level reshard and weight-aggregation terms, ``profile_cost``).
    Compute is ``ceil(batch / tiles)`` *whole samples* per device: data
    parallelism cannot split work within a sample, so a batch smaller than
    the tile count idles devices - the reason the feature-map-dominated
    front stays spatial at the paper's small edge batches, while spatial
    tiling keeps all tiles busy even at batch 1.
    """
    if mode == "data":
        compute = 0.0
        for idx in range(s, e + 1):
            l = layers[idx]
            oh, ow = ext[idx + 1]
            if l.pool:
                macs = oh * ow * max(l.in_channels, 1) * l.kernel * l.kernel
                passes = 1.0
            else:
                macs = oh * ow * l.kernel * l.kernel * l.in_channels * l.out_channels
                passes = 3.0
            compute += passes * macs
        return -(-batch // (n * m)) * compute / hw.flops, 0.0, 0.0, 0.0
    # Halo widths at the input of each layer of the group (interior tile =
    # worst case: halo on both sides).
    halo_lo, halo_hi = _halo_widths(layers, s, e)

    compute = 0.0
    for idx in range(s, e + 1):
        l = layers[idx]
        oh, ow = ext[idx + 1]
        k = idx - s
        ext_oh = oh // n + halo_lo[k + 1] + halo_hi[k + 1]
        ext_ow = ow // m + halo_lo[k + 1] + halo_hi[k + 1]
        if l.pool:
            macs = ext_oh * ext_ow * max(l.in_channels, 1) * l.kernel * l.kernel
        else:
            macs = ext_oh * ext_ow * l.kernel * l.kernel * l.in_channels * l.out_channels
        # fwd + delta backprop + weight grad ~= 3x fwd MACs (paper §4.1)
        compute += (1.0 if l.pool else 3.0) * macs
    compute_s = batch * compute / hw.flops

    ih, iw = ext[s]
    cin = max(layers[s].in_channels, 1)
    core_h, core_w = ih // n, iw // m
    halo_elems = (core_h + halo_lo[0] + halo_hi[0]) * (core_w + halo_lo[0] + halo_hi[0]) - core_h * core_w
    # fwd boundary + bwd boundary (delta halo ~ same width; paper §4.2 notes
    # wgrad reuses the fwd halo so it adds no traffic)
    boundary_s = batch * 2 * _xfer_seconds(
        halo_elems * cin, hw.dtype_bytes, hw.link_bw, hw.flops, wire_codec
    )
    sync_s = batch * 2 * hw.sync_latency

    hidden_s = 0.0
    if schedule == "overlap" and boundary_s > 0:
        lead = layers[s]
        rs = split_1d(ih // n, halo_lo[0], halo_hi[0], lead.kernel, lead.stride)
        csp = split_1d(iw // m, halo_lo[0], halo_hi[0], lead.kernel, lead.stride)
        if rs is not None and csp is not None:
            int_area = (rs.i1 - rs.i0 + 1) * (csp.i1 - csp.i0 + 1)
            if lead.pool:
                int_macs = int_area * max(lead.in_channels, 1) * lead.kernel ** 2
                passes = 1.0
            else:
                int_macs = (
                    int_area * lead.kernel ** 2 * lead.in_channels * lead.out_channels
                )
                passes = 3.0   # fwd + delta + wgrad overlap their halo legs alike
            interior_s = batch * passes * int_macs / hw.flops
            hidden_s = min(boundary_s, interior_s)
    return compute_s, boundary_s, sync_s, hidden_s


def _group_cost_cluster(
    layers: Sequence[LayerDef],
    ext: Sequence[tuple[int, int]],
    tiles,
    s: int,
    e: int,
    cluster: ClusterSpec,
    batch: int,
    mode: str = "spatial",
    wire_codec: str = "none",
) -> tuple[float, float, float, float]:
    """Heterogeneous-cluster group cost: per-*device* times from each
    device's own tile extents (the partition's boundary arrays) and its own
    link, reduced with max - the makespan of the group, since halo syncs
    are barriers at every group input.  Returned as (compute, boundary,
    sync, hidden) with compute/boundary the per-component maxima and
    ``hidden = max(compute) + max(boundary) - max(compute + boundary)``
    (subadditivity slack, >= 0) so the DP's ``c + b + y - h`` is exactly
    ``makespan + sync``.  No overlap-hiding credit: ragged groups run the
    sync exchange (DESIGN.md §8).

    ``mode="data"``: every device computes ceil(batch/T) whole samples of
    the identical full-map work, so the slowest device bounds the group -
    exact MACs / min FLOPs, no boundary, no sync."""
    rows, cols = tiles
    n, m = cluster.n, cluster.m
    if mode == "data":
        compute = 0.0
        for idx in range(s, e + 1):
            l = layers[idx]
            oh, ow = ext[idx + 1]
            if l.pool:
                macs = oh * ow * max(l.in_channels, 1) * l.kernel * l.kernel
                passes = 1.0
            else:
                macs = oh * ow * l.kernel * l.kernel * l.in_channels * l.out_channels
                passes = 3.0
            compute += passes * macs
        return -(-batch // (n * m)) * compute / cluster.min_flops, 0.0, 0.0, 0.0
    halo_lo, halo_hi = _halo_widths(layers, s, e)
    cin = max(layers[s].in_channels, 1)
    db = cluster.dtype_bytes
    comp_max = bound_max = tot_max = 0.0
    for i in range(n):
        for j in range(m):
            p = cluster.grid[i][j]
            macs = 0.0
            for idx in range(s, e + 1):
                l = layers[idx]
                k = idx - s
                ext_oh = rows[idx + 1][i] + halo_lo[k + 1] + halo_hi[k + 1]
                ext_ow = cols[idx + 1][j] + halo_lo[k + 1] + halo_hi[k + 1]
                if l.pool:
                    macs += ext_oh * ext_ow * max(l.in_channels, 1) * l.kernel ** 2
                else:
                    macs += (
                        3.0 * ext_oh * ext_ow * l.kernel ** 2
                        * l.in_channels * l.out_channels
                    )
                # Shape-specialization repad charge (DESIGN.md §9): every
                # layer output is rewritten into the canonical (max-tile)
                # extent, so each device pays for its pad slots.  Zero for
                # uniform partitions.
                canon_oh = max(rows[idx + 1]) + halo_lo[k + 1] + halo_hi[k + 1]
                canon_ow = max(cols[idx + 1]) + halo_lo[k + 1] + halo_hi[k + 1]
                cch = max(l.in_channels if l.pool else l.out_channels, 1)
                macs += SPEC_PAD_MACS * (canon_oh * canon_ow - ext_oh * ext_ow) * cch
            compute_ij = batch * macs / p.flops
            ch, cw = rows[s][i], cols[s][j]
            halo_elems = (
                (ch + halo_lo[0] + halo_hi[0]) * (cw + halo_lo[0] + halo_hi[0])
                - ch * cw
            )
            boundary_ij = batch * 2 * _xfer_seconds(
                halo_elems * cin, db, p.link_bw, p.flops, wire_codec
            )
            comp_max = max(comp_max, compute_ij)
            bound_max = max(bound_max, boundary_ij)
            tot_max = max(tot_max, compute_ij + boundary_ij)
    sync_s = batch * 2 * cluster.max_sync_latency
    return comp_max, bound_max, sync_s, comp_max + bound_max - tot_max


def _group_halo_lohi(layers: Sequence[LayerDef], s: int, e: int) -> tuple[int, int]:
    """(lo, hi) input halo of spatial group [s, e] (build_stack_plan's eq. 1
    recursion) - for feasibility pruning against a tile partition."""
    hl = hh = 0
    sprod = 1
    for l in range(s, e + 1):
        p = layers[l].padding
        hl += p * sprod
        hh += (layers[l].kernel - layers[l].stride - p) * sprod
        sprod *= layers[l].stride
    return hl, hh


def _any_group_cost(
    layers, ext, tiles, s, e, n, m, hw, batch, schedule, mode="spatial",
    wire_codec="none",
) -> tuple[float, float, float, float]:
    """Dispatch: homogeneous symmetric-tile model vs cluster makespan model."""
    if isinstance(hw, ClusterSpec):
        return _group_cost_cluster(
            layers, ext, tiles, s, e, hw, batch, mode, wire_codec
        )
    return _group_cost(
        layers, ext, s, e, n, m, hw, batch, schedule, mode, wire_codec
    )


def _filter_bytes(layers: Sequence[LayerDef], idxs, dtype_bytes: int) -> float:
    return sum(
        layers[i].kernel ** 2 * layers[i].in_channels * layers[i].out_channels * dtype_bytes
        for i in idxs
        if not layers[i].pool
    )


def _reshard_cost(
    ext, cross: int | None, layers: Sequence[LayerDef], tiles: int,
    hw: HardwareProfile, batch: int, wire_codec: str = "none",
) -> float:
    """One spatial->data reshard per sample per direction: the forward
    all-gather of the tile grid into full maps and its backward adjoint
    (reduce-scatter of the cotangent), each moving (T-1)/T of the full map
    at the crossover layer's input, plus one collective launch each."""
    if cross is None or tiles == 1:
        return 0.0
    h, w = ext[cross]
    ch = max(layers[cross].in_channels, 1)
    xfer = _xfer_seconds(
        h * w * ch * (tiles - 1) / tiles, hw.dtype_bytes, hw.link_bw,
        _hw_flops(hw), wire_codec,
    )
    return batch * (2.0 * xfer + 2.0 * hw.sync_latency)


# ---------------------------------------------------------------------------
# Pipeline stages (DESIGN.md §11): stage-assignment cost terms
# ---------------------------------------------------------------------------


def _tail_start(groups: Sequence[Group]) -> int | None:
    """First non-spatial layer (data crossover or pipeline entry) - the
    point past which nothing is spatially sharded.  At most one of the two
    exists (``validate_profile``)."""
    c = crossover_of(groups)
    return pipeline_first_of(groups) if c is None else c


def bubble_fraction(stages: int, microbatches: int) -> float:
    """Idle fraction of a fill/drain pipeline pass: S-1 of the S-1+M ticks
    each device sits out while the pipe fills and drains (DESIGN.md §11).
    The executor's tick scan realises exactly this schedule, so the model
    and the measured idle-slot census agree identically."""
    if stages < 1 or microbatches < 1:
        raise ValueError(
            f"bubble_fraction needs stages >= 1 and microbatches >= 1; "
            f"got S={stages}, M={microbatches}"
        )
    return (stages - 1) / (stages - 1 + microbatches)


def feasible_stage_counts(n: int, m: int, tail_layers: int) -> list[int]:
    """Stage counts S the executor can map onto an n x m mesh: S must split
    the n*m devices into equal *flat-contiguous* subsets whose boundaries
    align with mesh rows (so the inter-stage transfer is one axis-aligned
    ppermute) - i.e. a 1-D mesh, or a stage size that is a whole number of
    rows - and the tail must have at least one layer per stage."""
    out = []
    t = n * m
    for s in range(2, min(t, tail_layers) + 1):
        if t % s:
            continue
        p = t // s
        if n == 1 or m == 1 or p % m == 0:
            out.append(s)
    return out


def check_pipeline_arg(
    pipeline: int | str | None, n: int, m: int, n_layers: int
) -> None:
    """Validate the ``pipeline`` argument form early, with actionable
    errors - shared by the planner and the optimizer so every entry point
    (``--pipeline`` included) fails identically and before any executor
    tracing."""
    if pipeline is None or pipeline == "auto":
        return
    if isinstance(pipeline, bool) or not isinstance(pipeline, int):
        raise ValueError(
            f"pipeline must be None, 'auto', or an int stage count; "
            f"got {pipeline!r}"
        )
    if pipeline < 2:
        raise ValueError(
            f"pipeline stage count must be >= 2 (got {pipeline}): each stage "
            "needs its own device subset and a 1-stage pipeline is just the "
            "spatial/data plan - use pipeline=None (--pipeline none) to "
            "disable pipelining"
        )
    feas = feasible_stage_counts(n, m, n_layers)
    if pipeline not in feas:
        raise ValueError(
            f"pipeline stage count {pipeline} cannot map onto the {n}x{m} "
            f"mesh ({n_layers} layers): stages must be equal row-aligned "
            f"flat device ranges; feasible counts here: {feas or 'none'}"
        )


def _dense_macs3(layers: Sequence[LayerDef], ext, s: int, e: int) -> float:
    """Full-map MACs of layers [s, e] per sample, with the 3x fwd+delta+
    wgrad pass weighting (1x for pools) - the data/pipeline compute kernel."""
    macs = 0.0
    for idx in range(s, e + 1):
        l = layers[idx]
        oh, ow = ext[idx + 1]
        if l.pool:
            macs += oh * ow * max(l.in_channels, 1) * l.kernel * l.kernel
        else:
            macs += 3.0 * oh * ow * l.kernel * l.kernel * l.in_channels * l.out_channels
    return macs


def stage_cost(
    layers: Sequence[LayerDef],
    ext,
    g: Group,
    *,
    stage_size: int,
    hw: HardwareProfile | ClusterSpec,
    batch: int,
    first_stage: bool,
    wire_codec: str = "none",
) -> tuple[float, float]:
    """(compute_s, transfer_s) of one pipeline stage per batch, per device:
    each of the stage's ``stage_size`` devices computes ``ceil(batch /
    stage_size)`` whole samples of the stage's dense full-map work, and
    (except stage 0, whose entry traffic is the plan-level reshard term)
    receives its samples' input activations from the previous stage - the
    cotangents travel the same bytes back, hence the 2x."""
    comp = -(-batch // stage_size) * _dense_macs3(layers, ext, g.start, g.end) / hw.flops
    xfer = 0.0
    if not first_stage:
        h, w = ext[g.start]
        cin = max(layers[g.start].in_channels, 1)
        xfer = -(-batch // stage_size) * 2.0 * _xfer_seconds(
            h * w * cin, hw.dtype_bytes, hw.link_bw, _hw_flops(hw), wire_codec
        )
    return comp, xfer


def _pipeline_tail_cost(
    layers: Sequence[LayerDef],
    ext,
    pipe_groups: Sequence[Group],
    n: int,
    m: int,
    hw: HardwareProfile | ClusterSpec,
    batch: int,
    microbatches: int,
    wire_codec: str = "none",
) -> tuple[float, float, float, float]:
    """(compute, boundary, sync, bubble) of a pipeline tail per batch.

    Stages run concurrently, so the steady-state cost is the *makespan*
    (slowest stage bounds every tick) and the fill/drain idle time is the
    bubble: M microbatches take M + S - 1 ticks, so the slowest stage's
    per-batch time inflates by (S-1)/M - equivalently, a bubble fraction
    (S-1)/(S-1+M) of the elapsed pass (``bubble_fraction``).  Decomposed as
    compute = max stage compute, boundary = max stage transfer, sync = two
    collective launches per tick (fwd tick ppermute + its adjoint), bubble
    = (compute + boundary) * (S-1)/M."""
    s_count = len(pipe_groups)
    p = (n * m) // s_count
    comp_max = xfer_max = 0.0
    for k, g in enumerate(pipe_groups):
        comp, xfer = stage_cost(
            layers, ext, g, stage_size=p, hw=hw, batch=batch,
            first_stage=(k == 0), wire_codec=wire_codec,
        )
        comp_max = max(comp_max, comp)
        xfer_max = max(xfer_max, xfer)
    ticks = microbatches + s_count - 1
    sync = 2.0 * ticks * hw.sync_latency
    bubble = (comp_max + xfer_max) * (s_count - 1) / microbatches
    return comp_max, xfer_max, sync, bubble


def balance_stages(
    layers: Sequence[LayerDef],
    ext,
    start: int,
    end: int,
    stages: int,
    *,
    stage_size: int,
    hw: HardwareProfile | ClusterSpec,
    batch: int,
    wire_codec: str = "none",
) -> list[Group]:
    """Split layers [start, end) into ``stages`` contiguous pipeline groups
    minimising the modeled makespan (max per-stage compute + transfer-in) -
    the stage-assignment DP (DESIGN.md §11).  For a fixed (entry, S) the
    bubble and sync terms are split-independent, so minimising the makespan
    minimises the whole tail cost; brute-force-verified on small stacks.

    dp[i][k] = min over j of max(dp[j][k-1], cost(stage j..i)); O(L^2 S)."""
    L = end - start
    if stages < 1 or L < stages:
        raise ValueError(
            f"cannot split {L} pipeline layers [{start}, {end}) into "
            f"{stages} stages (need >= 1 layer per stage)"
        )

    def cost(s: int, e: int, first: bool) -> float:
        c, x = stage_cost(
            layers, ext, Group(s, e, "pipeline"),
            stage_size=stage_size, hw=hw, batch=batch, first_stage=first,
            wire_codec=wire_codec,
        )
        return c + x

    INF = float("inf")
    # dp[i][k]: best makespan covering layers [start, start+i) with k stages
    dp = [[INF] * (stages + 1) for _ in range(L + 1)]
    cut = [[0] * (stages + 1) for _ in range(L + 1)]
    dp[0][0] = 0.0
    for i in range(1, L + 1):
        for k in range(1, min(i, stages) + 1):
            for j in range(k - 1, i):
                c = cost(start + j, start + i - 1, first=(k == 1))
                cand = max(dp[j][k - 1], c)
                if cand < dp[i][k]:
                    dp[i][k] = cand
                    cut[i][k] = j
    bounds = []
    i, k = L, stages
    while k > 0:
        j = cut[i][k]
        bounds.append((start + j, start + i - 1))
        i, k = j, k - 1
    bounds.reverse()
    return [Group(s, e, "pipeline") for s, e in bounds]


def profile_cost(
    input_hw: tuple[int, int],
    layers: Sequence[LayerDef],
    groups: Sequence[Group],
    n: int,
    m: int,
    hw: HardwareProfile | ClusterSpec,
    batch: int = 1,
    schedule: str = "sync",
    *,
    partition: TilePartition | None = None,
    microbatches: int = PIPELINE_MICROBATCHES,
    wire_codec: str = "none",
) -> dict:
    """Total cycle cost split by component for a (possibly hybrid) grouping
    profile - per-group modes are read off the groups themselves.

    ``wire_codec`` prices every traffic term (halo boundary, reshard,
    pipeline hand-off, weight aggregation) through ``_xfer_seconds`` -
    compressed wire bytes plus the per-element quantize/dequantize compute
    - so planning under ``--wire-codec int8`` sees the cheaper wire and
    shifts the grouping/crossover the way the executor's codec actually
    changes the trade.  The weight term is included because the batch-end
    gradient all-reduce rides the same codec family
    (``optim.compress_with_feedback``).

    Under ``schedule="overlap"`` the ``hidden`` component (boundary time
    overlapped with interior compute) is subtracted from the total.

    Weight aggregation counts only *replicated* filters: under a hybrid
    plan the data-mode tail is the filter set whose per-batch data-parallel
    all-reduce the model charges (spatial-group filter gradients are
    per-tile partial sums whose batch-end aggregation the deferred schedule
    folds into the same collective - a modeling choice recorded in
    DESIGN.md §7); a pure-spatial plan keeps the full-stack charge, which
    is the executor's actual batch-end psum payload.

    ``hw`` may be a ``ClusterSpec``: spatial groups then cost the *makespan*
    over the per-device (tile, link) pairs of ``partition`` (or the
    ragged-even default partition when None), plan-level collective terms
    take the conservative cluster scalars, and the ``hidden`` overlap credit
    is the makespan's subadditivity slack (DESIGN.md §8).
    """
    _check_schedule(schedule)
    ext = _map_extents(input_hw, layers)
    tail = _tail_start(groups)
    tiles_rc = None
    if isinstance(hw, ClusterSpec):
        if (hw.n, hw.m) != (n, m):
            raise ValueError(f"cluster grid {(hw.n, hw.m)} != tile grid {(n, m)}")
        if partition is None:
            # score against the partition the planner would build
            partition = cluster_partition(input_hw, layers, hw, tail)
        tiles_rc = _layer_tiles(input_hw, layers, n, m, partition, tail)
    compute = boundary = sync = hidden = bubble = 0.0
    pipe_groups = [g for g in groups if g.mode == "pipeline"]
    for g in groups:
        if g.mode == "pipeline":
            continue
        c, b, s_, h = _any_group_cost(
            layers, ext, tiles_rc, g.start, g.end, n, m, hw, batch, schedule,
            mode=g.mode, wire_codec=wire_codec,
        )
        compute += c
        boundary += b
        sync += s_
        hidden += h
    if pipe_groups:
        c, b, s_, bub = _pipeline_tail_cost(
            layers, ext, pipe_groups, n, m, hw, batch, microbatches, wire_codec
        )
        compute += c
        boundary += b
        sync += s_
        bubble += bub
    tiles = n * m
    cross = crossover_of(groups)
    widx = range(len(layers)) if cross is None else range(cross, len(layers))
    welems = _filter_bytes(layers, widx, 1)
    if wire_codec == "none":
        weights = (
            2.0 * welems * hw.dtype_bytes * (tiles - 1) / tiles / hw.agg_bw
            + hw.sync_latency
        )
    else:
        weights = 2.0 * _xfer_seconds(
            welems * (tiles - 1) / tiles, hw.dtype_bytes, hw.agg_bw,
            _hw_flops(hw), wire_codec,
        ) + hw.sync_latency
    # The pipeline entry all-gathers the tile grid exactly like the data
    # crossover (same bytes on the wire), so both charge the same term.
    reshard = _reshard_cost(ext, tail, layers, tiles, hw, batch, wire_codec)
    total = compute + boundary + sync + weights + reshard + bubble - hidden
    return {
        "compute": compute,
        "boundary": boundary,
        "sync": sync,
        "weights": weights,
        "reshard": reshard,
        "hidden": hidden,
        "bubble": bubble,
        "total": total,
    }


def modeled_step_wire_bytes(
    input_hw: tuple[int, int],
    layers: Sequence[LayerDef],
    groups: Sequence[Group],
    n: int,
    m: int,
    hw: HardwareProfile | ClusterSpec,
    batch: int = 1,
    wire_codec: str = "none",
) -> dict:
    """Modeled bytes on the wire per training step (one ``batch``) under
    ``wire_codec``, split by traffic family - ``profile_cost``'s comm terms
    with the time divisors stripped.  The quantity behind the bench's
    ``bytes_per_step`` column and the int8 >= 4x wire-savings assertion:
    byte counts (unlike seconds) are independent of link speeds, so the
    none-vs-codec ratio isolates exactly what the codec buys.

      halo      2x per-group-input halo strip per sample (fwd + bwd)
      reshard   2x (T-1)/T of the crossover map per sample (all-gather +
                adjoint reduce-scatter)
      weights   2x (T-1)/T of the replicated filter set per batch (ring
                all-reduce of the gradients, which ride the same codec via
                ``optim.compress_with_feedback``)
      pipeline  2x each non-first stage's input activations per microbatch
                (tick hand-off + its adjoint)
    """
    ext = _map_extents(input_hw, layers)
    tiles = n * m
    halo = 0.0
    for g in groups:
        if g.mode != "spatial":
            continue
        halo_lo, halo_hi = _halo_widths(layers, g.start, g.end)
        ih, iw = ext[g.start]
        cin = max(layers[g.start].in_channels, 1)
        core_h, core_w = ih // n, iw // m
        halo_elems = (
            (core_h + halo_lo[0] + halo_hi[0]) * (core_w + halo_lo[0] + halo_hi[0])
            - core_h * core_w
        )
        halo += batch * 2.0 * modeled_wire_bytes(
            halo_elems * cin, hw.dtype_bytes, wire_codec
        )
    tail = _tail_start(groups)
    reshard = 0.0
    if tail is not None and tiles > 1:
        h, w = ext[tail]
        ch = max(layers[tail].in_channels, 1)
        reshard = batch * 2.0 * modeled_wire_bytes(
            h * w * ch * (tiles - 1) / tiles, hw.dtype_bytes, wire_codec
        )
    cross = crossover_of(groups)
    widx = range(len(layers)) if cross is None else range(cross, len(layers))
    welems = _filter_bytes(layers, widx, 1)
    weights = 2.0 * modeled_wire_bytes(
        welems * (tiles - 1) / tiles, hw.dtype_bytes, wire_codec
    )
    pipe_groups = [g for g in groups if g.mode == "pipeline"]
    pipeline = 0.0
    if pipe_groups:
        p = tiles // len(pipe_groups)
        for k, g in enumerate(pipe_groups):
            if k == 0:
                continue
            h, w = ext[g.start]
            cin = max(layers[g.start].in_channels, 1)
            pipeline += -(-batch // p) * 2.0 * modeled_wire_bytes(
                h * w * cin, hw.dtype_bytes, wire_codec
            )
    return {
        "halo": halo,
        "reshard": reshard,
        "weights": weights,
        "pipeline": pipeline,
        "total": halo + reshard + weights + pipeline,
    }


# ---------------------------------------------------------------------------
# Per-device peak-memory estimator (paper Fig. 6's metric, per mode)
# ---------------------------------------------------------------------------


def _spatial_group_mem(
    layers: Sequence[LayerDef], ext, s: int, e: int, n: int, m: int,
    batch: int, dtype_bytes: int, tiles=None,
) -> tuple[float, float]:
    """(activation_bytes, halo_bytes) of spatial group [s, e] on one device:
    halo-extended input tiles stored for backward (x2: feature + delta map)
    plus the transient group-input halo strips.  ``tiles`` (per-layer
    per-tile sizes): the ragged executor pads every device to the *largest*
    tile, so non-uniform partitions charge the max tile extent."""
    halo_lo, halo_hi = _halo_widths(layers, s, e)

    def shard(idx):
        if tiles is not None:
            return max(tiles[0][idx]), max(tiles[1][idx])
        ih, iw = ext[idx]
        return ih // n, iw // m

    act = 0.0
    for idx in range(s, e + 1):
        l = layers[idx]
        sh, sw = shard(idx)
        k = idx - s
        eh = sh + halo_lo[k] + halo_hi[k]
        ew = sw + halo_lo[k] + halo_hi[k]
        act += 2.0 * batch * eh * ew * max(l.in_channels, 1) * dtype_bytes
    sh, sw = shard(s)
    core = sh * sw
    ext_elems = (sh + halo_lo[0] + halo_hi[0]) * (sw + halo_lo[0] + halo_hi[0])
    halo = batch * (ext_elems - core) * max(layers[s].in_channels, 1) * dtype_bytes
    return act, halo


def peak_device_memory(
    input_hw: tuple[int, int],
    layers: Sequence[LayerDef],
    groups: Sequence[Group],
    n: int,
    m: int,
    *,
    batch: int = 1,
    dtype_bytes: int = 4,
    partition: TilePartition | None = None,
) -> dict:
    """Per-device training working set (bytes) under a (possibly hybrid)
    grouping profile - the quantity behind the paper's "up to 8x memory
    reduction per device" claim (Fig. 6), extended per partition mode:

      activations  stored layer inputs x2 (feature map + same-extent delta
                   map).  Spatial layers store the halo-*extended* tile for
                   the full batch; data layers store ceil(batch / (n*m))
                   *whole samples* of the full map (matching the cost
                   model's idle-device term) - at divisible batch the same
                   element count as an exact tile, so the crossover is
                   memory-neutral on the activation term and the savings
                   come from shed halos.
      halo         transient group-input receive strips (spatial groups).
      reshard_transient  the crossover instant's extra bytes: the tiled
                   all-gathers hold the full map for the whole local
                   microbatch before the batch slice drops to the steady
                   share.
      filters      weights + weight grads, full copy per device in spatial
                   and data modes - the constant floor behind Fig. 6's
                   diminishing returns.  Pipeline stages break that floor
                   (DESIGN.md §11): a stage's devices keep only the
                   *stage's* filters resident (every other layer's gradient
                   is structurally zero on them), so the charge is the
                   replicated prefix plus the heaviest stage - the
                   inter-layer memory win the paper's 8x claim targets.
      Pipeline activations: a stage device stores its ceil(batch / P)
                   samples of the stage's own layer inputs (P = devices per
                   stage) - charged as the heaviest stage.
    """
    ext = _map_extents(input_hw, layers)
    tiles = n * m
    tail = _tail_start(groups)
    tiles_rc = (
        None
        if partition is None
        else _layer_tiles(input_hw, layers, n, m, partition, tail)
    )
    pipe_groups = [g for g in groups if g.mode == "pipeline"]
    stage_devs = tiles // len(pipe_groups) if pipe_groups else tiles
    act = halo = 0.0
    pipe_act_max = 0.0
    for g in groups:
        if g.mode == "data":
            for idx in g.layers:
                ih, iw = ext[idx]
                act += (
                    2.0 * -(-batch // tiles) * ih * iw
                    * max(layers[idx].in_channels, 1) * dtype_bytes
                )
            continue
        if g.mode == "pipeline":
            stage_act = 0.0
            for idx in g.layers:
                ih, iw = ext[idx]
                stage_act += (
                    2.0 * -(-batch // stage_devs) * ih * iw
                    * max(layers[idx].in_channels, 1) * dtype_bytes
                )
            pipe_act_max = max(pipe_act_max, stage_act)
            continue
        a, h = _spatial_group_mem(
            layers, ext, g.start, g.end, n, m, batch, dtype_bytes, tiles_rc
        )
        act += a
        halo += h
    act += pipe_act_max
    # Reshard transient: the two tiled all-gathers materialise the full map
    # for the entire local microbatch before the batch slice keeps 1/T of
    # it - for one instant the crossover (or pipeline-entry) layer holds
    # batch (not ceil(batch/T)) whole maps.  Charged as the bytes *above*
    # the steady share already counted, so mem_limit filtering sees the
    # real peak, not just the steady state.
    reshard = 0.0
    if tail is not None and tail > 0 and tiles > 1:
        h_c, w_c = ext[tail]
        c_c = max(layers[tail].in_channels, 1)
        keep = stage_devs if pipe_groups else tiles
        reshard = (batch - -(-batch // keep)) * h_c * w_c * c_c * dtype_bytes
    if pipe_groups:
        shared = [l for l in range(len(layers)) if l < pipe_groups[0].start]
        stage_f_max = max(
            _filter_bytes(layers, g.layers, dtype_bytes) for g in pipe_groups
        )
        filters = 2.0 * (_filter_bytes(layers, shared, dtype_bytes) + stage_f_max)
    else:
        filters = 2.0 * _filter_bytes(layers, range(len(layers)), dtype_bytes)
    return {
        "activations": act,
        "halo": halo,
        "reshard_transient": reshard,
        "filters": filters,
        "total": act + halo + reshard + filters,
    }


def check_crossover_arg(crossover: int | str | None, n_layers: int) -> None:
    """Validate the crossover argument form - shared by the optimizer and
    the planner's explicit-groups path (``fusion._resolve_crossover``) so
    the two accept exactly the same spellings."""
    if crossover is None or crossover == "auto":
        return
    if isinstance(crossover, int):
        if not 0 <= crossover <= n_layers:
            raise ValueError(f"crossover must be in [0, {n_layers}]; got {crossover}")
        return
    raise ValueError(
        f"crossover must be None, an int layer index, or 'auto'; got {crossover!r}"
    )


def score_profile(
    input_hw: tuple[int, int],
    layers: Sequence[LayerDef],
    groups: Sequence[Group],
    n: int,
    m: int,
    hw: HardwareProfile | ClusterSpec,
    batch: int = 1,
    schedule: str = "sync",
    mem_limit: float | None = None,
    partition: TilePartition | None = None,
    microbatches: int = PIPELINE_MICROBATCHES,
    wire_codec: str = "none",
) -> float | None:
    """Modeled cycle total for a candidate profile, or None when its
    ``peak_device_memory`` total exceeds ``mem_limit``.  The single scoring
    routine behind every crossover-candidate comparison - the optimizer's
    joint DP scan and the planner's fixed-profile scan
    (``fusion._resolve_crossover``) both call this, so cost and feasibility
    can never diverge between the two.

    A ClusterSpec with no explicit partition resolves to the balanced
    partition the planner would build, so *both* the cost and the memory
    feasibility check model the padded tiles the ragged executor actually
    allocates."""
    if isinstance(hw, ClusterSpec) and partition is None:
        partition = cluster_partition(input_hw, layers, hw, _tail_start(groups))
    if mem_limit is not None:
        mem = peak_device_memory(
            input_hw, layers, groups, n, m, batch=batch,
            dtype_bytes=hw.dtype_bytes, partition=partition,
        )["total"]
        if mem > mem_limit:
            return None
    return profile_cost(
        input_hw, layers, groups, n, m, hw, batch, schedule, partition=partition,
        microbatches=microbatches, wire_codec=wire_codec,
    )["total"]


def optimize_grouping(
    input_hw: tuple[int, int],
    layers: Sequence[LayerDef],
    n: int,
    m: int,
    hw: HardwareProfile | ClusterSpec,
    batch: int = 1,
    max_group: int | None = None,
    schedule: str = "sync",
    crossover: int | str | None = None,
    mem_limit: float | None = None,
    partition: TilePartition | None = None,
    pipeline: int | str | None = None,
    microbatches: int = PIPELINE_MICROBATCHES,
    wire_codec: str = "none",
) -> list[Group]:
    """DP over group boundaries minimising modelled cycle time, optionally
    jointly with the spatial->data crossover layer.

    dp[e] = min over s<=e of dp[s-1] + cost(group(s, e)).  O(L^2) evaluations
    of the analytic model - instantaneous for real networks.  ``schedule``
    selects the executor the cost reflects ("overlap" credits boundary time
    hidden under the group lead's interior compute), so ``groups="auto"``
    planning tracks the executor it plans for.

    ``crossover``: None keeps the legacy all-spatial optimum; an int fixes
    the first data-mode layer; ``"auto"`` scans every candidate crossover c
    (plus "none"), scoring dp-optimal-spatial-prefix[0:c) + reshard(c) +
    data-tail(c..L) under the full ``profile_cost`` model - the data tail's
    cost is grouping-independent (no halos, no syncs), so one spatial DP
    table plus an O(L) scan is jointly optimal (brute-force-verified in
    tests).  Because the weight-aggregation term depends on the crossover
    (only the replicated data-tail filters are charged under a hybrid
    plan), candidates are compared on ``profile_cost(...)["total"]``
    directly, never on the DP table alone.

    ``mem_limit`` (bytes, per device): candidate plans whose
    ``peak_device_memory`` total exceeds the limit are discarded - the
    knob that reproduces the paper's Fig. 6 memory/speed trade-off.  Raises
    if no candidate fits.  This is a *feasibility filter on the cost-
    optimal candidates*, not a full cost-under-memory-budget search: the DP
    tracks only the cheapest grouping per prefix (plus a per-group
    working-set prune), so a feasible-but-costlier grouping that the DP
    never surfaces cannot be recovered by tightening the limit.

    ``pipeline``: None keeps pipeline tails out of the search entirely;
    ``"auto"`` adds pipeline-tail candidates (entry layer c x feasible
    stage count S, stages split by the ``balance_stages`` makespan DP) to
    the same ``profile_cost`` comparison, so the bubble/transfer terms
    compete directly with halo and reshard traffic; an int forces a
    pipeline tail with exactly that many stages.  When both ``crossover``
    and ``pipeline`` name an int, ``crossover`` denotes the
    spatial->pipeline entry layer (a plan has one non-spatial tail, never
    a data tail *and* a pipeline tail).  ``microbatches`` is the M the
    bubble fraction (S-1)/(S-1+M) is modelled against.
    """
    _check_schedule(schedule)
    L = len(layers)
    check_pipeline_arg(pipeline, n, m, L)
    ext = _map_extents(input_hw, layers)
    tiles_rc = None
    if isinstance(hw, ClusterSpec):
        if (hw.n, hw.m) != (n, m):
            raise ValueError(f"cluster grid {(hw.n, hw.m)} != tile grid {(n, m)}")
        # The DP scores spatial groups against the full-stack partition (the
        # crossover scan re-scores each candidate through profile_cost,
        # which re-balances per candidate); stacks whose final extent cannot
        # be partitioned need an explicit crossover.
        part_dp = (
            partition
            if partition is not None
            else cluster_partition(input_hw, layers, hw, None)
        )
        tiles_rc = _layer_tiles(input_hw, layers, n, m, part_dp, None)
    elif partition is not None:
        tiles_rc = _layer_tiles(input_hw, layers, n, m, partition, None)
    # the per-group memory prune charges the padded (max-tile) extents the
    # ragged executor allocates, matching score_profile's full check
    mem_tiles = tiles_rc
    max_group = max_group or L
    INF = float("inf")
    dp = [INF] * (L + 1)
    dp[0] = 0.0
    choice = [0] * (L + 1)
    for e in range(1, L + 1):
        for s in range(max(1, e - max_group + 1), e + 1):
            if tiles_rc is not None:
                # a group's halo must fit inside the smallest neighbouring
                # tile (build_stack_plan enforces this); under a skewed
                # non-uniform partition a fused group can be infeasible, so
                # the DP must never pick it
                hlo, hhi = _group_halo_lohi(layers, s - 1, e - 1)
                hmax = max(hlo, hhi)
                if hmax and (
                    min(tiles_rc[0][s - 1]) < hmax or min(tiles_rc[1][s - 1]) < hmax
                ):
                    continue
            c, b, y, h = _any_group_cost(
                layers, ext, tiles_rc, s - 1, e - 1, n, m, hw, batch, schedule,
                wire_codec=wire_codec,
            )
            if mem_limit is not None:
                # necessary condition: one group's own working set must fit
                a, hl = _spatial_group_mem(layers, ext, s - 1, e - 1, n, m, batch,
                                           hw.dtype_bytes, mem_tiles)
                if a + hl > mem_limit:
                    continue
            cand = dp[s - 1] + c + b + y - h
            if cand < dp[e]:
                dp[e] = cand
                choice[e] = s - 1

    def backtrack(e: int) -> list[Group]:
        out: list[Group] = []
        while e > 0:
            s = choice[e]
            out.append(Group(s, e - 1))
            e = s
        out.reverse()
        return out

    if crossover is None and pipeline is None:
        if dp[L] == INF:
            raise ValueError(
                f"no feasible spatial grouping (mem_limit={mem_limit}, "
                "partition halo constraints); raise the limit, use a less "
                "skewed partition, or enable a crossover"
            )
        groups = backtrack(L)
        if (
            score_profile(input_hw, layers, groups, n, m, hw, batch, schedule,
                          mem_limit, partition=partition, wire_codec=wire_codec)
            is None
        ):
            raise ValueError(
                "cost-optimal spatial grouping exceeds "
                f"mem_limit={mem_limit}; raise the limit or enable a crossover"
            )
        return groups

    if crossover is not None:
        check_crossover_arg(crossover, L)

    best: tuple[float, list[Group]] | None = None

    # Non-pipeline candidates (all-spatial plus data-tail crossovers).
    # Skipped when a pipeline tail is *forced* — then only stage counts
    # compete — but always present under pipeline="auto" so the bubble
    # term competes against plain halo/reshard traffic.
    if pipeline is None or pipeline == "auto":
        if crossover is None:
            candidates: list[int | None] = [None]
        elif crossover == "auto":
            candidates = [None] + list(range(L))
        else:
            candidates = [None if crossover == L else crossover]
        for c in candidates:
            prefix_len = L if c is None else c
            if dp[prefix_len] == INF:
                continue
            groups = backtrack(prefix_len)
            if c is not None:
                groups = groups + [Group(c, L - 1, mode="data")]
            cost = score_profile(
                input_hw, layers, groups, n, m, hw, batch, schedule, mem_limit,
                partition=partition, microbatches=microbatches,
                wire_codec=wire_codec,
            )
            if cost is None:
                continue
            if best is None or cost < best[0]:
                best = (cost, groups)

    # Pipeline-tail candidates: entry layer c x feasible stage count S.
    # The spatial prefix [0:c) reuses the same DP table; the tail [c:L)
    # is split into S stages by the balance_stages makespan DP.
    if pipeline is not None:
        if crossover is None or crossover == "auto":
            entries: Sequence[int] = range(L)
        else:
            entries = [] if crossover == L else [crossover]
        for c in entries:
            if dp[c] == INF:
                continue
            prefix = backtrack(c)
            counts = feasible_stage_counts(n, m, L - c)
            if pipeline != "auto":
                counts = [s for s in counts if s == pipeline]
            for s_count in counts:
                stages = balance_stages(
                    layers, ext, c, L, s_count,
                    stage_size=(n * m) // s_count, hw=hw, batch=batch,
                    wire_codec=wire_codec,
                )
                groups = prefix + stages
                cost = score_profile(
                    input_hw, layers, groups, n, m, hw, batch, schedule,
                    mem_limit, partition=partition, microbatches=microbatches,
                    wire_codec=wire_codec,
                )
                if cost is None:
                    continue
                if best is None or cost < best[0]:
                    best = (cost, groups)
    if best is None:
        raise ValueError(
            f"no grouping/crossover/pipeline candidate fits mem_limit={mem_limit}"
        )
    return best[1]
