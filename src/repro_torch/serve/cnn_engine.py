"""Tiled-CNN serving engine: request queue + dynamic batching under a
latency budget over forward-only StackPlans (DESIGN.md §13).

The port of ``repro/serve/cnn_engine.py``, with the same dispatch policy
and statistics.  Queued image requests are packed into the smallest batch
bucket that covers them (zero-padded) and dispatched through one prepared
serve step per bucket (``serve/exec_cache.py``): on a CUDA mesh the forward
captured as a CUDA graph (``CapturedStep``, the counterpart of the
reference's AOT-compiled executable), on the CPU the eager forward.  Each
bucket stages its batch in one reused host buffer (pinned on the card) and
reads the output back into another; the responses are a copy of it, which
the next dispatch leaves alone.  A batch ships when the
queue fills the largest bucket, or as soon as the oldest request's deadline
headroom drops below ``slack_factor`` step bounds.  The step bound comes
from the same ``profile_cost`` model the planner optimizes against
(``modeled_step_bound``), unless the caller gives one.  A hybrid plan's
forward leaves its output in batch blocks; ``make_tiled_forward`` puts them
back in input order, so responses are read by position for every plan.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.fusion import StackPlan, make_tiled_infer, resolve_hw_profile
from repro_torch.core.grouping import ClusterSpec, profile_cost
from repro_torch.kernels.conv2d_tiled.kernel import launch_counts
from repro_torch.launch.mesh import DistTileMesh, TileMesh
from repro_torch.serve.exec_cache import CapturedStep, ExecutableCache, plan_cache_key


@dataclasses.dataclass
class ImageRequest:
    """One queued inference request: a single (H, W, C) image."""

    rid: int
    image: np.ndarray
    deadline: float | None = None       # absolute; default submitted + budget
    submitted: float | None = None      # stamped by Engine.submit
    completed: float | None = None
    result: np.ndarray | None = None

    @property
    def latency(self) -> float | None:
        if self.completed is None or self.submitted is None:
            return None
        return self.completed - self.submitted


class ManualClock:
    """Deterministic injectable clock for tests: time advances only via
    ``advance`` (plus the engine's simulated service time)."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += float(dt)


def modeled_step_bound(
    plan: StackPlan,
    batch: int,
    hw: Any = None,
) -> float:
    """Modeled seconds for one serve step at ``batch`` - ``profile_cost``'s
    total for the plan's grouping on ``hw`` (a HardwareProfile, ClusterSpec,
    registered name, or None for the Pi default).  This is the deadline
    policy's service-time estimate; serving reuses the planner's cost model
    rather than growing a second one."""
    cost = profile_cost(
        plan.input_hw,
        plan.layers,
        plan.groups,
        plan.n,
        plan.m,
        hw if isinstance(hw, ClusterSpec) else resolve_hw_profile(hw),
        batch=batch,
        schedule=plan.schedule,
        partition=plan.partition,
        wire_codec=plan.wire_codec,
    )
    return float(cost["total"])


class CNNServeEngine:
    """Dynamic-batching serve loop over a forward-only StackPlan.

    plan, mesh, params: the serve step; ``plan`` must be forward-only
        (``inference=True``) and ``params`` tensors on ``mesh.device``.
    buckets: ascending batch-bucket ladder.
    latency_budget: default per-request deadline (seconds after submit).
    step_bound: seconds per serve step the deadline policy plans with
        (default: ``modeled_step_bound`` on ``cluster`` or ``hw`` at the
        largest bucket).
    hw, cluster: the hardware profile (or name) and the ClusterSpec the
        modeled bound is priced on; ``cluster`` also keys the cache.
    slack_factor: ship a partial batch when the oldest request's headroom
        is below ``slack_factor * step_bound``.
    cache: a shared ``ExecutableCache``; private by default.
    clock: time source; inject ``ManualClock`` for deterministic tests.
    simulate_step_s: with a ManualClock, advance it by this much per
        dispatch to model service time.
    capture: serve each bucket from a captured CUDA graph (True) or from
        the eager forward (False); None (default) captures exactly when the
        mesh is on a CUDA device.  True on a CPU mesh raises.
    """

    def __init__(
        self,
        plan: StackPlan,
        mesh: TileMesh,
        params: Sequence[dict],
        *,
        buckets: Sequence[int] = (1, 2, 4, 8),
        latency_budget: float = 0.1,
        step_bound: float | None = None,
        hw: Any = None,
        cluster: ClusterSpec | None = None,
        slack_factor: float = 2.0,
        cache: ExecutableCache | None = None,
        cache_capacity: int = 16,
        clock: Callable[[], float] = time.monotonic,
        simulate_step_s: float | None = None,
        dtype=np.float32,
        capture: bool | None = None,
    ):
        if not plan.inference:
            raise ValueError(
                "CNNServeEngine needs a forward-only plan: take "
                "plan.inference_twin() (and freeze_bn_stats the params) - "
                "serving a training plan would use BN batch statistics "
                "across requests"
            )
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints; got {buckets!r}")
        if plan.crossover is not None:
            t = plan.n * plan.m
            bad = [b for b in buckets if b % t]
            if bad:
                raise ValueError(
                    f"hybrid plan: buckets {bad} not divisible by the tile "
                    f"count {plan.n}x{plan.m}={t} (data-mode batch split)"
                )
        if isinstance(mesh, DistTileMesh):
            raise ValueError(
                "the serve engine on ranks (its inference twin captured, buckets dispatched "
                "on every rank) is ROADMAP A.20.4; make_tiled_infer runs a forward on ranks")
        on_cuda = mesh is not None and mesh.device.type == "cuda"
        if capture and not on_cuda:
            raise ValueError(
                "capture=True needs a CUDA mesh: a CUDA graph has no CPU counterpart "
                "(the CPU engine runs the eager forward)"
            )
        self.capture = on_cuda if capture is None else bool(capture)
        self.plan = plan
        self.mesh = mesh
        self.params = params
        self.buckets = buckets
        self.latency_budget = float(latency_budget)
        self.cluster = cluster
        self.step_bound = (
            float(step_bound)
            if step_bound is not None
            else modeled_step_bound(plan, buckets[-1], cluster if cluster is not None else hw)
        )
        self.slack_factor = float(slack_factor)
        self.clock = clock
        self.simulate_step_s = simulate_step_s
        self.dtype = dtype
        h, w = plan.input_hw
        self._img_shape = (h, w, plan.layers[0].in_channels)
        self.cache = cache if cache is not None else ExecutableCache(cache_capacity)
        self._infer = make_tiled_infer(plan, mesh)
        self._tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        self._captured: dict[int, CapturedStep] = {}
        self._stage: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        self.queue: deque[ImageRequest] = deque()
        self.finished: list[ImageRequest] = []
        self.batch_log: list[dict] = []     # per dispatch: t, bucket, filled, slack
        self._rid = 0

    # -- preparation ---------------------------------------------------------

    def _prepare(self, bucket: int):
        """The serve step for one bucket, ``step(params, x) -> y`` with ``x``
        on the host or the device: the forward captured at the bucket's
        shape (``CapturedStep``; B1's launches counted at the capture), or
        one warm eager run (which builds the CUDA kernels on first use) and
        then the eager forward, restricted to that batch size."""
        shape = (bucket, *self._img_shape)
        device = self.mesh.device
        self._staging(bucket)
        if self.capture:
            step = CapturedStep(self._infer, self.params, shape, dtype=self._tdtype,
                                device=device, counters=launch_counts)
            self._captured[bucket] = step
            return step
        infer = self._infer
        infer(self.params, torch.zeros(shape, dtype=self._tdtype, device=device))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

        def step(params, xb):
            if xb.shape[0] != bucket:
                raise ValueError(f"bucket-{bucket} step got batch {xb.shape[0]}")
            return infer(params, xb.to(device, non_blocking=True))

        return step

    def executable(self, bucket: int):
        """The prepared serve step for one bucket, through the keyed cache."""
        key = plan_cache_key(self.plan, bucket, self.cluster)
        return self.cache.get_or_build(key, lambda: self._prepare(bucket))

    def warmup(self) -> dict:
        """Prepare the whole bucket ladder (startup, before traffic)."""
        for b in self.buckets:
            self.executable(b)
        return self.cache.stats()

    # -- request lifecycle ---------------------------------------------------

    def submit(self, image: np.ndarray, *, deadline: float | None = None) -> ImageRequest:
        image = np.ascontiguousarray(image, self.dtype)
        if image.shape != self._img_shape:
            raise ValueError(
                f"request image shape {image.shape} != plan input {self._img_shape}"
            )
        now = self.clock()
        req = ImageRequest(
            rid=self._rid,
            image=image,
            submitted=now,
            deadline=deadline if deadline is not None else now + self.latency_budget,
        )
        self._rid += 1
        self.queue.append(req)
        return req

    def _pick_bucket(self, k: int) -> int:
        """Smallest bucket covering k requests (largest if k exceeds it)."""
        for b in self.buckets:
            if b >= k:
                return b
        return self.buckets[-1]

    def step(self, force: bool = False) -> list[ImageRequest]:
        """Admit-or-wait decision + at most one dispatched batch: ships when
        the queue fills the largest bucket, the oldest request's headroom is
        below ``slack_factor * step_bound``, or ``force`` (draining)."""
        if not self.queue:
            return []
        now = self.clock()
        full = len(self.queue) >= self.buckets[-1]
        must_ship = (self.queue[0].deadline - now) <= self.slack_factor * self.step_bound
        if not (full or must_ship or force):
            return []
        bucket = self._pick_bucket(len(self.queue))
        take = min(len(self.queue), bucket)
        reqs = [self.queue.popleft() for _ in range(take)]
        xb, out = self._staging(bucket)
        for i, r in enumerate(reqs):
            xb[i].copy_(torch.from_numpy(r.image))
        xb[take:].zero_()
        slack = min(r.deadline for r in reqs) - (now + self.step_bound)
        y = self.executable(bucket)(self.params, xb)
        out.copy_(y, non_blocking=True)
        if self.mesh.device.type == "cuda":
            torch.cuda.current_stream(self.mesh.device).synchronize()
        ys = out[:take].clone().numpy()
        if self.simulate_step_s is not None and hasattr(self.clock, "advance"):
            self.clock.advance(self.simulate_step_s)
        done = self.clock()
        for i, r in enumerate(reqs):
            r.result = ys[i]
            r.completed = done
        self.finished.extend(reqs)
        self.batch_log.append({"t": now, "bucket": bucket, "filled": take, "slack": slack})
        return reqs

    def _staging(self, bucket: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The bucket's reused input and output buffers on the host, pinned on
        the card, made when the bucket is prepared (a pinned allocation
        costs milliseconds, which a first dispatch should not pay).  They
        are filled by torch's copies, which split a large copy over the
        host's threads where numpy's runs on one (``chip_smoke.py`` phase
        17 times both)."""
        if bucket not in self._stage:
            pin = self.mesh.device.type == "cuda"
            oh, ow = self.plan.out_hw()
            self._stage[bucket] = (
                torch.empty((bucket, *self._img_shape), dtype=self._tdtype, pin_memory=pin),
                torch.empty((bucket, oh, ow, self.plan.layers[-1].out_channels),
                            dtype=self._tdtype, pin_memory=pin),
            )
        return self._stage[bucket]

    def drain(self, max_steps: int = 10_000) -> list[ImageRequest]:
        """Dispatch until the queue is empty (partial batches ship now)."""
        out: list[ImageRequest] = []
        while self.queue and max_steps:
            out.extend(self.step(force=True))
            max_steps -= 1
        return out

    @property
    def pending(self) -> int:
        return len(self.queue)

    # -- accounting ----------------------------------------------------------

    def stats(self) -> dict:
        """Latency percentiles, throughput, bucket census, dispatch slack,
        cache statistics and the captured graphs (buckets, replays, pool
        bytes and B1 launches a graph, by bucket) over everything completed
        so far."""
        lats = sorted(r.latency for r in self.finished if r.latency is not None)
        census: dict[int, int] = {}
        for b in self.batch_log:
            census[b["bucket"]] = census.get(b["bucket"], 0) + 1
        out = {
            "served": len(self.finished),
            "dispatches": len(self.batch_log),
            "bucket_census": census,
            "fill_rate": (
                sum(b["filled"] for b in self.batch_log)
                / max(1, sum(b["bucket"] for b in self.batch_log))
            ),
            "min_slack_s": min((b["slack"] for b in self.batch_log), default=None),
            "deadline_misses": sum(
                1
                for r in self.finished
                if r.deadline is not None
                and r.completed is not None
                and r.completed > r.deadline
            ),
            "cache": self.cache.stats(),
            "capture": {
                "buckets": sorted(self._captured),
                "replays": {b: s.replays for b, s in sorted(self._captured.items())},
                "pool_bytes": {b: s.pool_bytes for b, s in sorted(self._captured.items())},
                "launches": {b: s.launches for b, s in sorted(self._captured.items())},
            },
            "step_bound_s": self.step_bound,
        }
        if lats:
            first = min(r.submitted for r in self.finished)
            last = max(r.completed for r in self.finished)
            span = max(last - first, 1e-12)
            out.update(
                {
                    "p50_s": lats[len(lats) // 2],
                    "p99_s": lats[min(len(lats) - 1, int(len(lats) * 0.99))],
                    "throughput": len(lats) / span,
                }
            )
        return out
