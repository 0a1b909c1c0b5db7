"""Tiled-CNN serving engine: request queue + dynamic batching under a
latency budget over forward-only StackPlans (DESIGN.md §13).

The port of ``repro/serve/cnn_engine.py``, with the same dispatch policy
and statistics.  Queued image requests are packed into the smallest batch
bucket that covers them (zero-padded) and dispatched through one prepared
serve step per bucket (``serve/exec_cache.py``).  A batch ships when the
queue fills the largest bucket, or as soon as the oldest request's deadline
headroom drops below ``slack_factor`` step bounds.

The reference derives the step bound from the planner's cost model
(``modeled_step_bound``); that model is not ported yet (ROADMAP A.9), so
this engine takes ``step_bound`` explicitly.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.fusion import StackPlan, make_tiled_infer
from repro_torch.launch.mesh import TileMesh
from repro_torch.serve.exec_cache import ExecutableCache, plan_cache_key


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


class CNNServeEngine:
    """Dynamic-batching serve loop over a forward-only StackPlan.

    plan, mesh, params: the serve step; ``plan`` must be forward-only
        (``inference=True``) and ``params`` tensors on ``mesh.device``.
    buckets: ascending batch-bucket ladder.
    latency_budget: default per-request deadline (seconds after submit).
    step_bound: seconds per serve step the deadline policy plans with
        (required: the modeled bound needs the cost model, ROADMAP A.9).
    slack_factor: ship a partial batch when the oldest request's headroom
        is below ``slack_factor * step_bound``.
    cache: a shared ``ExecutableCache``; private by default.
    clock: time source; inject ``ManualClock`` for deterministic tests.
    simulate_step_s: with a ManualClock, advance it by this much per
        dispatch to model service time.
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
        slack_factor: float = 2.0,
        cache: ExecutableCache | None = None,
        cache_capacity: int = 16,
        clock: Callable[[], float] = time.monotonic,
        simulate_step_s: float | None = None,
        dtype=np.float32,
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
        if step_bound is None:
            raise ValueError(
                "step_bound (seconds per serve step) is required: the modeled "
                "bound needs the grouping cost model, not ported yet (ROADMAP A.9)"
            )
        self.plan = plan
        self.mesh = mesh
        self.params = params
        self.buckets = buckets
        self.latency_budget = float(latency_budget)
        self.step_bound = float(step_bound)
        self.slack_factor = float(slack_factor)
        self.clock = clock
        self.simulate_step_s = simulate_step_s
        self.dtype = dtype
        h, w = plan.input_hw
        self._img_shape = (h, w, plan.layers[0].in_channels)
        self.cache = cache if cache is not None else ExecutableCache(cache_capacity)
        self._infer = make_tiled_infer(plan, mesh)
        self.queue: deque[ImageRequest] = deque()
        self.finished: list[ImageRequest] = []
        self.batch_log: list[dict] = []     # per dispatch: t, bucket, filled, slack
        self._rid = 0

    # -- preparation ---------------------------------------------------------

    def _prepare(self, bucket: int):
        """The serve step for one bucket: one warm run at the bucket's shape
        (which builds the CUDA kernels on first use), then the forward
        callable, restricted to that batch size."""
        infer = self._infer
        x = np.zeros((bucket, *self._img_shape), self.dtype)
        infer(self.params, torch.from_numpy(x).to(self.mesh.device))
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)

        def step(params, xb):
            if xb.shape[0] != bucket:
                raise ValueError(f"bucket-{bucket} step got batch {xb.shape[0]}")
            return infer(params, xb)

        return step

    def executable(self, bucket: int):
        """The prepared serve step for one bucket, through the keyed cache."""
        key = plan_cache_key(self.plan, bucket)
        return self.cache.get_or_build(key, lambda: self._prepare(bucket))

    def warmup(self) -> dict:
        """Prepare the whole bucket ladder (startup, before traffic)."""
        for b in self.buckets:
            self.executable(b)
        return self.cache.stats()

    # -- request lifecycle ---------------------------------------------------

    def submit(self, image: np.ndarray, *, deadline: float | None = None) -> ImageRequest:
        image = np.asarray(image, self.dtype)
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
        x = np.zeros((bucket, *self._img_shape), self.dtype)
        for i, r in enumerate(reqs):
            x[i] = r.image
        slack = min(r.deadline for r in reqs) - (now + self.step_bound)
        xt = torch.from_numpy(x).to(self.mesh.device)
        y = self.executable(bucket)(self.params, xt).cpu().numpy()
        if self.simulate_step_s is not None and hasattr(self.clock, "advance"):
            self.clock.advance(self.simulate_step_s)
        done = self.clock()
        for i, r in enumerate(reqs):
            r.result = y[i]
            r.completed = done
        self.finished.extend(reqs)
        self.batch_log.append({"t": now, "bucket": bucket, "filled": take, "slack": slack})
        return reqs

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
        """Latency percentiles, throughput, bucket census, dispatch slack and
        cache statistics over everything completed so far."""
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
