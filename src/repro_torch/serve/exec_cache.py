"""Prepared-executable cache for tiled-CNN serving (DESIGN.md §13).

The port of ``repro/serve/exec_cache.py``.  ``ExecutableCache`` keys a
prepared serve step by the full plan identity (``plan_manifest``) plus the
batch bucket, with LRU eviction and hit/miss counters.  In the port the
cached artifact is a forward callable whose build compiled the kernels on
first use and ran one warm launch at the bucket's shape; CUDA-graph capture
per bucket is later work.
"""
from __future__ import annotations

import json
from collections import OrderedDict
from typing import Any, Callable, Hashable

from repro_torch.core.fusion import StackPlan, plan_manifest
from repro_torch.core.grouping import ClusterSpec


def plan_cache_key(
    plan: StackPlan,
    bucket: int,
    cluster: ClusterSpec | None = None,
) -> tuple[str, int]:
    """Canonical hashable key for (plan, batch-bucket[, cluster]): the
    sorted JSON of ``plan_manifest``, so every plan knob that reaches the
    manifest - the cluster the plan was balanced for included -
    distinguishes keys by construction."""
    return (json.dumps(plan_manifest(plan, cluster), sort_keys=True), int(bucket))


class ExecutableCache:
    """LRU cache of prepared serve steps with hit/miss counters.

    ``get_or_build(key, build)`` returns the cached value and counts a hit,
    or calls ``build()``, inserts, counts a miss, and evicts the
    least-recently-used entry past ``capacity``.  ``misses`` is therefore
    the build count."""

    def __init__(self, capacity: int = 8):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self._entries: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def keys(self):
        """Keys in LRU order (least recently used first)."""
        return list(self._entries.keys())

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        if key in self._entries:
            self._entries.move_to_end(key)
            self.hits += 1
            return self._entries[key]
        value = build()
        self.misses += 1
        self._entries[key] = value
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
        return value

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
            "entries": len(self._entries),
            "capacity": self.capacity,
        }
