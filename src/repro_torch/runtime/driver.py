"""Drivers of ``repro/runtime/driver.py``: ``run_training`` and
``run_serving``, each under a watchdog.

``run_training`` runs the step loop with the reference's straggler count
and bounded retry.  Checkpoints, resume, fault injection and elastic replan
are ROADMAP A.15: without a checkpoint a retried step restarts the run from
a fresh state, as the reference does before its first save, and
``DriverReport.restarts`` counts every retry, so a caller can tell a clean
run from one that hid a failure.  The other counts of the report cover the
last attempt only.
"""
from __future__ import annotations

import dataclasses
import logging
import statistics
import threading
import time
from typing import Any, Callable, Optional

import torch

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class DriverConfig:
    """The reference's driver settings that act without checkpoints."""

    ckpt_dir: Optional[str] = None   # checkpoints: ROADMAP A.15; None only
    max_restarts: int = 3
    straggler_factor: float = 2.0
    hang_timeout: float = 300.0
    log_every: int = 0               # 0 = no periodic metric logging


@dataclasses.dataclass
class DriverReport:
    steps_done: int = 0
    restarts: int = 0
    straggler_steps: int = 0
    step_times: list = dataclasses.field(default_factory=list)
    last_metrics: Optional[dict] = None


@dataclasses.dataclass
class ServeReport:
    """Outcome of a ``run_serving`` drive: request counts, latency
    percentiles, dispatch-slack floor, bucket census, cache stats."""

    served: int = 0
    dispatches: int = 0
    deadline_misses: int = 0
    min_slack_s: Optional[float] = None
    p50_s: Optional[float] = None
    p99_s: Optional[float] = None
    throughput: Optional[float] = None
    bucket_census: dict = dataclasses.field(default_factory=dict)
    cache: dict = dataclasses.field(default_factory=dict)


class Watchdog:
    def __init__(self, timeout: float):
        self.timeout = timeout
        self._last = time.monotonic()
        self._hung = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def beat(self):
        self._last = time.monotonic()

    @property
    def hung(self) -> bool:
        return self._hung.is_set()

    def _run(self):
        while not self._stop.wait(min(self.timeout / 4, 5.0)):
            if time.monotonic() - self._last > self.timeout:
                self._hung.set()
                log.error("watchdog: no step completed in %.0fs", self.timeout)

    def stop(self):
        self._stop.set()
        self._thread.join()


def run_serving(
    engine,
    *,
    ticks: int,
    on_tick: Optional[Callable[[int, Any], None]] = None,
    hang_timeout: float = 300.0,
    drain: bool = True,
) -> ServeReport:
    """Drive a ``serve.cnn_engine.CNNServeEngine``: a watchdog heartbeats
    every engine step (a wedged device surfaces as a hang signal) and the
    outcome comes back as a ``ServeReport``.

    ``on_tick(t, engine)`` is the traffic source: it submits requests and/or
    advances an injected virtual clock.  Each tick runs the engine's
    admit-or-wait decision once; after ``ticks``, ``drain=True`` ships
    whatever is still queued."""
    watchdog = Watchdog(hang_timeout)
    try:
        for t in range(ticks):
            if on_tick is not None:
                on_tick(t, engine)
            engine.step()
            watchdog.beat()
        if drain:
            engine.drain()
            watchdog.beat()
    finally:
        watchdog.stop()
    s = engine.stats()
    return ServeReport(
        served=s["served"],
        dispatches=s["dispatches"],
        deadline_misses=s["deadline_misses"],
        min_slack_s=s["min_slack_s"],
        p50_s=s.get("p50_s"),
        p99_s=s.get("p99_s"),
        throughput=s.get("throughput"),
        bucket_census=s["bucket_census"],
        cache=s["cache"],
    )


def _scalar(v) -> float:
    return float(v.item() if isinstance(v, torch.Tensor) else v)


def run_training(
    *,
    init_state: Callable[[int], Any],
    train_step: Callable[[Any, dict], tuple[Any, dict]],
    make_batch: Callable[[int], dict],
    steps: int,
    cfg: DriverConfig,
    seed: int = 0,
    fault_hook: Optional[Callable[[int], None]] = None,
    faults=None,
) -> DriverReport:
    """Run ``steps`` steps: ``make_batch(step)`` must be deterministic, so a
    restarted run replays the same stream; ``fault_hook(step)`` may raise to
    inject a failure; ``faults`` (the reference's fault schedule) is
    ROADMAP A.15.  A failed step is retried up to ``cfg.max_restarts``
    times, each time from ``init_state(seed)`` at step 0 (no checkpoint to
    restore), and the report's step count and times start over with it.
    Each step ends with its metrics read back to the host, so
    the step time on the host clock covers the work on the card."""
    if cfg.ckpt_dir is not None:
        raise NotImplementedError("checkpoints and resume: ROADMAP A.15 (elastic training)")
    if faults is not None:
        raise NotImplementedError("fault schedules and elastic replan: ROADMAP A.15 (elastic training)")
    report = DriverReport()
    watchdog = Watchdog(cfg.hang_timeout)
    state = init_state(seed)
    step = 0
    try:
        while step < steps:
            try:
                t0 = time.monotonic()
                if fault_hook is not None:
                    fault_hook(step)
                state, metrics = train_step(state, make_batch(step))
                report.last_metrics = {k: _scalar(v) for k, v in metrics.items()}
                dt = time.monotonic() - t0
                watchdog.beat()
                report.step_times.append(dt)
                if cfg.log_every and (step + 1) % cfg.log_every == 0:
                    log.info("step %d: %s (%.3fs)", step, " ".join(
                        f"{k}={v:.5g}" for k, v in sorted(report.last_metrics.items())), dt)
                if len(report.step_times) >= 5:
                    med = statistics.median(report.step_times[-50:])
                    if dt > cfg.straggler_factor * med:
                        report.straggler_steps += 1
                        log.warning("straggler: step %d took %.3fs (median %.3fs)", step, dt, med)
                report.steps_done += 1
                step += 1
            except Exception as e:  # noqa: BLE001 - any step failure is retryable
                report.restarts += 1
                log.exception("step %d failed (%s); restart %d", step, e, report.restarts)
                if report.restarts > cfg.max_restarts:
                    raise
                state = init_state(seed)
                step = 0
                report.steps_done = report.straggler_steps = 0
                report.step_times.clear()
    finally:
        watchdog.stop()
    return report
