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

``halo_permute_bytes`` is what the uniform sync plan's exchanges must put in
one rank's record for one microbatch, from the plan's geometry alone.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict


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


def halo_permute_bytes(plan, batch: int, ranks: tuple[int, int]) -> int:
    """The payload bytes of one rank's halo permutes over one microbatch of
    ``batch`` images of the uniform sync ``plan`` (fp32 strips), its grid
    over ``ranks`` (Rr, Rc): each group input's row round (the block's edge
    strip of ``top`` and of ``bottom`` rows), then its column round over
    the row-extended block, in the forward and once more in the backward
    of every group but the first (whose input, the image, takes no
    gradient)."""
    bn, bm = plan.n // ranks[0], plan.m // ranks[1]
    total = 0
    for gi, g in enumerate(plan.groups):
        top, bottom, left, right = plan.group_halos[gi]
        h, w = plan.shard_hw[g.start]
        c = plan.layers[g.start].in_channels
        once = (bm * batch * (top + bottom) * w * c
                + bn * batch * (h + top + bottom) * (left + right) * c)
        total += once * (2 if gi > 0 else 1)
    return total * 4
