"""Collective traffic of a run on ranks: the reference's ``CollectiveStats``
and ring model (``repro/analysis/hlo.py``), filled from the collectives a
rank recorded (``parallel/dist.py:TileGroup.record``) instead of parsed from
compiled HLO text.  A record counts every collective the rank issued, loop
iterations included, so it is what the reference's
``collectives_with_loops`` reads with trip counts applied.

Per op, as the reference counts it on each device:

    all-gather          recv = out_bytes * (g-1)/g       (out = gathered result)
    all-reduce          ring = 2 * out_bytes * (g-1)/g
    collective-permute  out_bytes                        (one hop)

``plan_collectives`` is what a plan's exchanges, reshard and hand-offs
must put in one rank's record for one microbatch, from the plan's geometry
alone: the sync exchange's shifts, the overlap schedule's packed swap (one
collective a 2-tile axis, lo and hi strips together, where two ranks hold
the axis), a ragged partition's two strips a round at the padded extents,
the hybrid plans' gathers and their adjoints, a pipeline's entry gathers
and its hand-offs, each payload leaf of a wire codec its own collective.

``plan_collectives(..., forward_only=True)`` is one serve dispatch's
forward: each exchange once, the crossover's gathers without their
adjoints, and the gather of the output on every rank; ``dispatch_collectives``
the serve engine's broadcasts beside it (rank 0's header and batch).

``driver_collectives`` is what the elastic driver adds beside the steps on
ranks (``runtime/driver.py``): one 4-byte agreement before each step a rank
attempts, a meeting of the world at each replan and at the run's end, and
the state's broadcasts (the params' init, a restore, a rank's return).  A
record holds them under their own ``role`` (``dist.Collective``);
``split_record`` keeps them apart from a step's collectives, which
``plan_collectives`` models.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter, defaultdict

from repro_torch.optim.compression import _auto_block, get_codec
from repro_torch.parallel.dist import AGREE_BYTES, DISPATCH_WORDS, MEET_WORDS


@dataclasses.dataclass
class CollectiveStats:
    """Per-device collective traffic of one record."""

    count: dict                  # op kind -> #collectives
    bytes_naive: dict            # op kind -> sum of result bytes
    bytes_ring: dict             # op kind -> ring-model link bytes
    per_op: list                 # (kind, result_bytes, group_size, times)

    @property
    def total_naive(self) -> int:
        return sum(self.bytes_naive.values())

    @property
    def total_ring(self) -> int:
        return sum(self.bytes_ring.values())


def _ring_bytes(kind: str, out_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(out_bytes) * (g - 1)
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    if kind == "collective-permute":
        return float(out_bytes)
    return 0.0


def collective_stats(record) -> CollectiveStats:
    """The stats of a record: how many times each ``dist.Collective``
    (kind, bytes, group size) ran, as ``TileGroup.record`` counts
    them.  ``per_op`` holds one entry per distinct collective with its
    count, as the reference's ``collectives_with_loops`` gives each
    instruction with its trip count."""
    count: dict = defaultdict(int)
    naive: dict = defaultdict(int)
    ring: dict = defaultdict(float)
    per_op: list = []
    for c, times in record.items():
        count[c.kind] += times
        naive[c.kind] += c.nbytes * times
        ring[c.kind] += _ring_bytes(c.kind, c.nbytes, c.group) * times
        per_op.append((c.kind, c.nbytes, c.group, times))
    return CollectiveStats(dict(count), dict(naive), dict(ring), per_op)


def leaf_bytes(codec_spec: str, n_el: int) -> list[int]:
    """The bytes of each payload leaf of one tile's ``n_el`` fp32 values on
    the wire: the values (no codec); int8 codes in whole blocks and one
    fp32 scale a block (``WireCodec.encode``); top-k's fp32 values and
    int32 indices."""
    codec = get_codec(codec_spec)
    if codec is None:
        return [4 * n_el]
    if codec.kind == "int8":
        block = _auto_block(n_el, codec.block)
        nb = math.ceil(n_el / block)
        return [nb * block, 4 * nb]
    k = codec._k_eff(n_el)
    return [4 * k, 4 * k]


def plan_collectives(plan, batch: int, ranks: tuple[int, int],
                     coord: tuple[int, int] = (0, 0), forward_only: bool = False) -> dict:
    """``{kind: [count, bytes]}`` the rank at ``coord`` of the rank grid
    ``ranks`` (Rr, Rc) records over one microbatch of ``batch`` images of
    ``plan`` (fp32 activations), forward and backward, all-reduces aside.
    ``forward_only``: one serve dispatch of ``batch`` images instead, the
    forward alone (``make_tiled_forward``: a codec's strips stateless, as
    in training's forward) and then the gather of the output blocks on
    every rank (uncompressed: one ``all-gather`` of every rank's block,
    recorded even on one rank); a pipeline plan has no such forward and
    raises.

    Per group input with a halo: the row round (each side's edge strip of
    the block, or the packed lo+hi strip of an overlap lead on a 2-tile
    axis, swapped only where two ranks hold the axis), then the column
    round over the row-extended tiles; a ragged partition's round ships
    the lo and the hi strip on their own, each at the padded extent of the
    other axis (the column round at the row round's canonical extent).
    Per crossover: the gather along the rank rows, then the rank columns
    (under a codec, of each payload leaf), only where the axis has more
    than one rank; a ragged plan gathers its padded tiles.  Each exchange
    runs once more in the backward, unless its input is the image, which
    takes no gradient: the reverse shift or swap, and a reshard's
    reduce-scatter (uncompressed) or all-to-all of the chunks (a codec).

    A pipeline tail: its spatial prefix as above, then the entry's two
    gathers of the prefix's tiles (uncompressed, as the reference's) and
    their reduce-scatters where the prefix takes a gradient; per stage
    boundary one hand-off from each rank holding tiles of the sending
    stage whose destinations lie in another block, and one reverse
    hand-off of the cotangent from each rank holding the receiving
    stage's, of those tiles' blocks (batch / tiles per stage images) at
    their true extents, or at the reference's container under a codec.
    Only a pipeline's record depends on ``coord``."""
    if forward_only and plan.stages:
        raise ValueError("a pipeline plan has no single-shot forward to serve")
    rr, rc = ranks
    bn, bm = plan.n // rr, plan.m // rc
    codec = plan.wire_codec
    out: dict = defaultdict(lambda: [0, 0])

    def add(kind, tiles, n_el, times, leaves=None):
        for b in leaves or leaf_bytes(codec, n_el):
            out[kind][0] += times
            out[kind][1] += times * tiles * b

    def gathers(tile, col, adjoint, compressed):
        if rr > 1:
            add("all-gather", rr * bn * bm, tile, 1, None if compressed else [4 * tile])
        if rc > 1:
            add("all-gather", rc * bm, col, 1, None if compressed else [4 * col])
        if adjoint and not compressed:
            if rc > 1:
                add("reduce-scatter", plan.n * bm, tile, 1, [4 * tile])
            if rr > 1:
                add("reduce-scatter", bn * bm, tile, 1, [4 * tile])
        elif adjoint:
            if rc > 1:
                add("all-to-all", bn * bm * plan.m, col, 1)
            if rr > 1:
                add("all-to-all", bn * bm * plan.n, tile, 1)

    uniform = plan.is_uniform
    for gi, g in enumerate(plan.groups):
        times = 2 if gi > 0 and not forward_only else 1
        h, w = plan.shard_hw[g.start]
        c = plan.layers[g.start].in_channels
        if g.mode == "pipeline":
            break
        if g.mode == "data":
            if gi > 0 and plan.groups[gi - 1].mode == "data":
                continue
            tile = batch * h * w * c
            gathers(tile, plan.n * tile, gi > 0 and not forward_only,
                    get_codec(codec) is not None)
            continue
        top, bottom, left, right = plan.group_halos[gi]
        packed = uniform and plan.schedule == "overlap" and any(plan.group_halos[gi])
        rows_ext = h + top + bottom
        if not uniform:
            from repro_torch.core.fusion import _ragged_group_geom

            rows_ext = _ragged_group_geom(plan, gi)["ein"][0][0]
        for axis, lo, hi, rows, cols in ((0, top, bottom, None, w),
                                         (1, left, right, rows_ext, None)):
            tiles_axis, ranks_axis = (plan.n, rr) if axis == 0 else (plan.m, rc)
            edge = bm if axis == 0 else bn

            def strip(k):
                return batch * c * (k * cols if axis == 0 else rows * k)

            if packed and (tiles_axis == 1 or lo == hi == 0):
                continue
            if packed and tiles_axis == 2 and lo > 0 and hi > 0:
                if ranks_axis == 2:
                    add("collective-permute", bn * bm, strip(lo + hi), times)
                continue
            for k in (lo, hi):
                if k > 0:
                    add("collective-permute", edge, strip(k), times)
    if plan.stages:
        _pipeline_collectives(plan, batch, (rr, rc), coord, add, gathers)
    if forward_only:
        c_out = plan.layers[-1].out_channels
        if plan.crossover is not None:
            per_tile = batch // (plan.n * plan.m) * math.prod(plan.out_hw()) * c_out
        else:
            per_tile = batch * math.prod(plan.shard_hw[-1]) * c_out
        add("all-gather", rr * rc * bn * bm, per_tile, 1, [4 * per_tile])
    return {k: list(v) for k, v in out.items()}


def _pipeline_collectives(plan, batch, ranks, coord, add, gathers) -> None:
    """``plan_collectives``' entry gathers and hand-offs of a pipeline
    tail (``core/fusion.py:_make_pipeline_local``)."""
    from repro_torch.core.fusion import _pipeline_geometry, _stage_span

    geom = _pipeline_geometry(plan)
    pf = geom["pfirst"]
    if pf:
        h, w = plan.shard_hw[pf]
        tile = batch * h * w * plan.layers[pf].in_channels
        gathers(tile, plan.n * tile, True, False)
    (rr, rc), (pr, pc) = ranks, coord
    block = (plan.n // rr, plan.m // rc)
    origin = (pr * block[0], pc * block[1])
    bp = batch // geom["per_stage"]
    codec = get_codec(plan.wire_codec)
    for s in range(geom["n_stages"] - 1):
        g = geom["groups"][s]
        dims = (*plan.map_hw[g.end + 1], plan.layers[g.end].out_channels)
        n_el = bp * math.prod(geom["container"] if codec is not None else dims)
        dim, lo, hi = _stage_span(plan, s)
        shift = hi - lo
        o, b = origin[dim], block[dim]
        line = block[1 - dim]                   # tiles of the block per position
        for first, end, step in ((lo, hi, shift), (hi, hi + shift, -shift)):
            leaving = sum(1 for q in range(max(o, first), min(o + b, end))
                          if not o <= q + step < o + b)
            if leaving:
                add("collective-permute", leaving * line, n_el, 1)


def split_record(record) -> tuple[Counter, dict]:
    """A rank's record -> (its steps' collectives, the driver's by role:
    ``{role: [count, bytes]}``)."""
    steps, roles = Counter(), {}
    for c, times in record.items():
        if c.role:
            got = roles.setdefault(c.role, [0, 0])
            got[0] += times
            got[1] += times * c.nbytes
        else:
            steps[c] += times
    return steps, roles


def dispatch_collectives(buckets, image_bytes: int, stops: int = 1) -> dict:
    """``{"dispatch": [count, bytes]}`` the serve engine records on every
    rank beside its forwards (``serve/cnn_engine.py``): per dispatch, of
    each bucket in ``buckets``, rank 0's header of ``DISPATCH_WORDS`` int32
    words and its zero-padded batch (bucket x ``image_bytes``), and
    ``stops`` headers that end the followers' loops."""
    buckets = list(buckets)
    heads = len(buckets) + stops
    return {"dispatch": [heads + len(buckets),
                         4 * DISPATCH_WORDS * heads + image_bytes * sum(buckets)]}


def driver_collectives(*, agreements: int, meetings: int, decisions: int = 0,
                       shares: dict | None = None) -> dict:
    """``{role: [count, bytes]}`` the elastic driver records on a rank
    beside its steps: ``agreements`` 4-byte all-reduces (one before each
    step the rank attempts while active, whatever was agreed),
    ``meetings`` all-reduces of ``MEET_WORDS`` int32 words (each replan, and
    the run's end), ``decisions`` 4-byte broadcasts of rank 0's choice
    (whether a checkpoint is resumed at the start, which step a restore
    loaded), and ``shares``: ``{role: (times, leaf bytes)}``, one broadcast
    a tensor leaf each time (``init``: the params; ``restore``, ``return``:
    the state)."""
    out = {}
    if agreements:
        out["agree"] = [agreements, AGREE_BYTES * agreements]
    if meetings:
        out["meeting"] = [meetings, 4 * MEET_WORDS * meetings]
    for role, (times, leaves) in (shares or {}).items():
        if times:
            got = out.setdefault(role, [0, 0])
            got[0] += times * len(leaves)
            got[1] += times * sum(leaves)
    if decisions:
        got = out.setdefault("restore", [0, 0])
        got[0] += decisions
        got[1] += AGREE_BYTES * decisions
    return out
