"""Prepared-executable cache for tiled-CNN serving (DESIGN.md §13).

The port of ``repro/serve/exec_cache.py``.  ``ExecutableCache`` keys a
prepared serve step by the full plan identity (``plan_manifest``) plus the
batch bucket, with LRU eviction and hit/miss counters.  The reference
caches one ahead-of-time-compiled XLA executable per (plan, bucket), so
that the forward is never rebuilt on the hot path; the port's counterpart
is ``CapturedStep``: the forward captured once as a CUDA graph at the
bucket's shape and replayed at every dispatch, with the reference
executable's contract ``step(params, x) -> y``.  A graph bakes in the
addresses it was captured with, so the step holds a static input buffer and
static copies of the params (``ParamBinder``), and copies a caller's params
in before a replay whenever they are not the tensors it last bound.  The
cache stays generic over the build function; a CPU engine caches an eager
step instead (``serve/cnn_engine.py``).
"""
from __future__ import annotations

import json
from collections import OrderedDict
from typing import Any, Callable, Hashable

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.core.fusion import StackPlan, plan_manifest
from repro_torch.core.grouping import ClusterSpec
from repro_torch.parallel.dist import capture_pass, replay_record


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
    the build count: on the card, the number of captures."""

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


def _version(t: torch.Tensor) -> int | None:
    """``t``'s in-place version, or None for an inference tensor, which
    tracks none."""
    return None if t.is_inference() else t._version


class ParamBinder:
    """Static copies of a params tree, the tensors a captured graph reads.

    ``bind(params)`` makes the static copies equal ``params``: leaves that
    are the tensors it last bound, at the same in-place version
    (``_version``), are left alone; every other leaf - a swapped tensor, an
    in-place update, an inference tensor (which tracks no version) - is
    copied in with one ``torch._foreach_copy_``.  A tree of another
    structure, or a leaf of another shape or dtype, raises.  Writes that
    bypass the version counter (``.data``) are not seen."""

    def __init__(self, params: Any):
        leaves, self._spec = tree_flatten(params)
        with torch.no_grad():
            self._static = [leaf.detach().clone() for leaf in leaves]
        self.static = tree_unflatten(self._static, self._spec)
        self._src = list(leaves)
        self._ver = [_version(leaf) for leaf in leaves]
        self.copies = 0         # bind calls that copied at least one leaf

    def bind(self, params: Any) -> bool:
        """Bring the static copies up to ``params``; True when it copied."""
        leaves, spec = tree_flatten(params)
        if spec != self._spec:
            raise ValueError("params do not have the structure the step was captured with")
        stale = [i for i, leaf in enumerate(leaves)
                 if leaf is not self._src[i] or _version(leaf) is None
                 or _version(leaf) != self._ver[i]]
        if not stale:
            return False
        for i in stale:
            got, want = leaves[i], self._static[i]
            if got.shape != want.shape or got.dtype != want.dtype:
                raise ValueError(
                    f"param leaf {i}: {got.dtype} {tuple(got.shape)}, captured with "
                    f"{want.dtype} {tuple(want.shape)}"
                )
        with torch.no_grad():
            torch._foreach_copy_([self._static[i] for i in stale], [leaves[i] for i in stale])
        for i in stale:
            self._src[i], self._ver[i] = leaves[i], _version(leaves[i])
        self.copies += 1
        return True


# warm runs before a capture: the first builds the kernels and makes every
# plan constant (``launch/mesh.py:plan_constant``); the second runs as the
# capture will, from the built state
WARM_RUNS = 2


def kernel_launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count as one flat dict: ``"<name>"``
    and, for the wrappers that split theirs, ``"<name>/<instance>"``.  A
    captured graph's launches are the difference across its capture."""
    from repro_torch.kernels.conv2d_tiled.backward import conv2d_dgrad_tile, conv2d_wgrad_tile
    from repro_torch.kernels.conv2d_tiled.kernel import launch_counts
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm
    from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_fwd

    out = launch_counts()
    for f in (conv2d_dgrad_tile, conv2d_wgrad_tile, flash_attention_fwd, ssd_chunk_fwd, rmsnorm):
        out[f.__name__] = f.launches
        for k, v in getattr(f, "launches_by_instance", {}).items():
            out[f"{f.__name__}/{k}"] = v
    return out


class CapturedStep:
    """One forward captured as a CUDA graph at one input shape: the port of
    the reference's AOT-compiled serve executable, ``step(params, x) -> y``.

    Construction runs ``fwd(params, x)`` ``WARM_RUNS`` times on a side
    stream on a static input buffer and the static params, then captures it
    once under ``torch.cuda.graph`` into a private memory pool.  A call
    copies ``x`` (host or device, the captured shape and dtype) into the
    static input, binds ``params`` (``ParamBinder``), replays the graph on
    the current stream and returns a clone of the static output, which the
    next call does not overwrite.  Nothing falls back to an eager run: a
    capture or replay that fails raises.

    ``counters()`` returns the kernel launch counts (name -> count) the
    wrappers keep; ``launches`` holds what they counted during the capture,
    the launches each replay runs again without Python, and ``replays``
    counts the replays.  ``pool_bytes`` is the device memory the graph's
    pool reserved.

    On ranks (``group``, nccl: a forward on a ``DistTileMesh``) the graph
    holds the forward's collectives - the halo exchanges, a crossover's
    gathers and the output's gather - as ``train/trainer.py:
    CapturedTrainStep`` holds a step's: the warm runs make every
    communicator, every rank captures at the same call, the capture runs
    in thread-local mode, and its pass's record is taken out of the
    group's record (``collectives``) and added back at every replay.  The
    static input ``x`` is what a rank receives a dispatch's batch into."""

    def __init__(self, fwd: Callable, params: Any, x_shape, *, dtype: torch.dtype,
                 device: torch.device, counters: Callable[[], dict], group=None):
        from repro_torch.parallel.dist import check_capture

        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA-graph capture needs a CUDA device; got {device}")
        if group is not None:
            check_capture(group)
        self.group = group
        self._binder = ParamBinder(params)
        with torch.cuda.device(device):
            self._x = torch.zeros(tuple(x_shape), dtype=dtype, device=device)
            stream = torch.cuda.current_stream(device)
            side = torch.cuda.Stream(device)
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                for _ in range(WARM_RUNS):
                    fwd(self._binder.static, self._x)
            stream.wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            with capture_pass(group) as self.collectives, torch.cuda.graph(
                    self._graph, capture_error_mode="global" if group is None else "thread_local"):
                # read on entry, after the context has synchronized, collected
                # garbage and emptied the allocator's cache: from here the
                # reserved bytes grow by the graph's pool alone
                reserved = torch.cuda.memory_reserved(device)
                before = counters()
                self._y = fwd(self._binder.static, self._x)
                after = counters()
            self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = {k: v - before[k] for k, v in after.items() if v != before[k]}
        self.replays = 0

    @property
    def rebinds(self) -> int:
        """Calls whose params had to be copied into the static ones."""
        return self._binder.copies

    @property
    def x(self) -> torch.Tensor:
        """The static input the graph reads."""
        return self._x

    def __call__(self, params: Any, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != tuple(self._x.shape) or x.dtype != self._x.dtype:
            raise ValueError(
                f"captured for {self._x.dtype} {tuple(self._x.shape)}; got {x.dtype} "
                f"{tuple(x.shape)}"
            )
        self._x.copy_(x, non_blocking=True)
        return self.replay(params)

    def replay(self, params: Any) -> torch.Tensor:
        """Bind ``params`` and replay on whatever the static input holds."""
        self._binder.bind(params)
        self._graph.replay()
        self.replays += 1
        if self.group is not None:
            replay_record(self.group.record, self.collectives)
        return self._y.clone()
