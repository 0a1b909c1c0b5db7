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

``plan_collectives`` is what a uniform plan's exchanges and reshard must
put in one rank's record for one microbatch, from the plan's geometry
alone: the sync exchange's shifts, the overlap schedule's packed swap (one
collective a 2-tile axis, lo and hi strips together, where two ranks hold
the axis), the hybrid plans' gathers and their adjoints, each payload leaf
of a wire codec its own collective.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict

from repro_torch.optim.compression import _auto_block, get_codec


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


def plan_collectives(plan, batch: int, ranks: tuple[int, int]) -> dict:
    """``{kind: [count, bytes]}`` one rank records over one microbatch of
    ``batch`` images of the uniform ``plan`` (fp32 activations), forward
    and backward, all-reduces aside; its grid over ``ranks`` (Rr, Rc).

    Per group input with a halo: the row round (each side's edge strip of
    the block, or the packed lo+hi strip of an overlap lead on a 2-tile
    axis, swapped only where two ranks hold the axis), then the column
    round over the row-extended tiles.  Per crossover: the gather along
    the rank rows, then the rank columns (under a codec, of each payload
    leaf), only where the axis has more than one rank.  Each exchange runs
    once more in the backward, unless its input is the image, which takes
    no gradient: the reverse shift or swap, and a reshard's reduce-scatter
    (uncompressed) or all-to-all of the chunks (a codec)."""
    if not plan.is_uniform or plan.stages:
        raise ValueError("plan_collectives models uniform plans without a pipeline tail")
    rr, rc = ranks
    bn, bm = plan.n // rr, plan.m // rc
    codec = plan.wire_codec
    out: dict = defaultdict(lambda: [0, 0])

    def add(kind, tiles, n_el, times):
        for b in leaf_bytes(codec, n_el):
            out[kind][0] += times
            out[kind][1] += times * tiles * b

    for gi, g in enumerate(plan.groups):
        times = 2 if gi > 0 else 1
        h, w = plan.shard_hw[g.start]
        c = plan.layers[g.start].in_channels
        if g.mode == "data":
            if gi > 0 and plan.groups[gi - 1].mode == "data":
                continue
            n, m = plan.n, plan.m
            tile, col = batch * h * w * c, batch * n * h * w * c
            if rr > 1:
                add("all-gather", rr * bn * bm, tile, 1)
            if rc > 1:
                add("all-gather", rc * bm, col, 1)
            if gi > 0 and get_codec(codec) is None:
                if rc > 1:
                    add("reduce-scatter", n * bm, tile, 1)
                if rr > 1:
                    add("reduce-scatter", bn * bm, tile, 1)
            elif gi > 0:
                if rc > 1:
                    add("all-to-all", bn * bm * m, col, 1)
                if rr > 1:
                    add("all-to-all", bn * bm * n, tile, 1)
            continue
        top, bottom, left, right = plan.group_halos[gi]
        packed = plan.schedule == "overlap" and any(plan.group_halos[gi])
        for axis, lo, hi, rows, cols in ((0, top, bottom, None, w),
                                         (1, left, right, h + top + bottom, None)):
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
    return {k: list(v) for k, v in out.items()}

