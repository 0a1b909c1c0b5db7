"""Drivers of ``repro/runtime/driver.py``: ``run_training`` and
``run_serving``, each under a watchdog.

``run_training`` wraps the train step with the reference's operational
machinery (DESIGN.md §10):

  - checkpoint/restart: periodic saves (async by default) through
    ``ckpt.manager.CheckpointManager``; a failed step restores the newest
    loadable checkpoint and replays the deterministic stream from the step
    after it, up to ``max_restarts`` times;
  - resume (``auto``, ``always``, ``never``), falling back past a corrupt
    newest step;
  - straggler count against a rolling median, and a watchdog thread;
  - elastic replan: a ``ClusterChange`` raised out of the step loop (by
    ``runtime.faults.FaultInjector`` or a device-health monitor) goes to the
    ``replan`` callback, which builds the step for the changed cluster; the
    live state carries over and training continues at the same step;
  - fault injection: ``faults`` replays a ``runtime.faults`` schedule
    through these paths.

Without a checkpoint directory (``ckpt_dir=None``) nothing is saved.  A
retried step with no checkpoint to restore restarts the run from a fresh
state at step 0, and the report's step count and times start over with it,
so they cover the last attempt.  A restore from a checkpoint keeps them, as
the reference does: its replayed steps count again.
``DriverReport.restarts`` counts every retry either way, so a caller can
tell a clean run from one that hid a failure.
"""
from __future__ import annotations

import dataclasses
import logging
import statistics
import threading
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.runtime.faults import ClusterChange, FaultInjector

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class DriverConfig:
    """The reference's driver settings.  ``ckpt_dir=None`` (the port's
    default) runs without checkpoints."""

    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 2.0
    hang_timeout: float = 300.0
    async_ckpt: bool = True
    log_every: int = 0               # 0 = no periodic metric logging
    resume: str = "auto"             # auto | always | never
    io_retries: int = 3              # checkpoint IO retry budget
    io_backoff: float = 0.05         # base backoff (doubles per retry)


@dataclasses.dataclass
class DriverReport:
    steps_done: int = 0
    restarts: int = 0
    replans: int = 0
    straggler_steps: int = 0
    resumed_step: Optional[int] = None   # checkpoint step resumed from
    step_times: list = dataclasses.field(default_factory=list)
    last_metrics: Optional[dict] = None


@dataclasses.dataclass
class ServeReport:
    """Outcome of a ``run_serving`` drive: request counts, latency
    percentiles, dispatch-slack floor, bucket census, cache stats and the
    engine's captured graphs (``CNNServeEngine.stats()["capture"]``)."""

    served: int = 0
    dispatches: int = 0
    deadline_misses: int = 0
    min_slack_s: Optional[float] = None
    p50_s: Optional[float] = None
    p99_s: Optional[float] = None
    throughput: Optional[float] = None
    bucket_census: dict = dataclasses.field(default_factory=dict)
    cache: dict = dataclasses.field(default_factory=dict)
    capture: dict = dataclasses.field(default_factory=dict)


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
        capture=s["capture"],
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
    faults: Optional[FaultInjector] = None,
    replan: Optional[Callable[[ClusterChange], tuple[Callable, Any]]] = None,
    plan: Any = None,
    device: Optional[str | torch.device] = None,
) -> DriverReport:
    """Run ``steps`` steps with checkpoint/restart fault tolerance.

    ``make_batch(step)`` must be deterministic, so a restart replays the
    stream; ``fault_hook(step)`` may raise to inject a failure; ``faults``
    is a ``runtime.faults.FaultInjector`` replaying a parsed schedule
    (device drops arrive as ``ClusterChange``).  Each step ends with its
    metrics read back to the host, so the step time on the host clock
    covers the work on the card.

    ``plan`` is an optional JSON-serializable plan manifest
    (``core.fusion.plan_manifest``) stored with every checkpoint.  A
    ``ClusterChange`` goes to ``replan(event)``, which returns
    ``(new_train_step, new_plan_manifest)`` built for the changed cluster;
    the live state carries over as it is (on the virtual tile mesh its
    leaves are already the global tensors; optimizer statistics pass
    through untouched) and the run continues at the same step.  Without
    ``replan`` a ClusterChange is fatal (re-raised after draining saves).

    ``cfg.resume``: "auto" restores the newest loadable checkpoint when one
    exists, "always" requires one (FileNotFoundError otherwise), "never"
    starts fresh.  Restores fall back past a corrupted newest step and the
    stream resumes from the step actually loaded.  Restored tensors land on
    ``device``, by default the device ``init_state``'s tensors are made on
    (found by tracing it without allocating); the reference's
    ``state_shardings`` have no meaning on one card."""
    if cfg.resume not in ("auto", "always", "never"):
        raise ValueError(f"resume must be auto|always|never; got {cfg.resume!r}")
    mgr = None
    if cfg.ckpt_dir is not None:
        mgr = CheckpointManager(cfg.ckpt_dir, io_retries=cfg.io_retries,
                                io_backoff=cfg.io_backoff)
    elif faults is not None and any(f.kind in ("ckpt-crash", "corrupt") for f in faults.faults):
        raise ValueError("ckpt-crash and corrupt faults act on checkpoints: give a ckpt_dir")
    if faults is not None:
        faults.bind(mgr)
    report = DriverReport()

    def restore_latest():
        from repro_torch.train.trainer import abstract_of

        like, dev = abstract_of(init_state, seed)
        return mgr.restored_step(like, device=device if device is not None else dev)

    def drain():
        if mgr is not None:
            mgr.wait()

    state = None
    step = 0
    if mgr is not None:
        if cfg.resume == "always" and mgr.latest_step() is None:
            raise FileNotFoundError(f"resume='always' but no checkpoint in {cfg.ckpt_dir}")
        if cfg.resume != "never" and mgr.latest_step() is not None:
            state, loaded = restore_latest()
            report.resumed_step, step = loaded, loaded + 1
            log.info("restored checkpoint at step %d", loaded)
    watchdog = Watchdog(cfg.hang_timeout)
    try:
        if state is None:
            state = init_state(seed)
        while step < steps:
            try:
                t0 = time.monotonic()
                if faults is not None:
                    faults.on_step(step)
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
                if mgr is not None and ((step + 1) % cfg.ckpt_every == 0 or step + 1 == steps):
                    mgr.save(step, state, blocking=not cfg.async_ckpt, plan=plan)
                step += 1
            except ClusterChange as ev:
                # the device set changed: rebuild the step for the survivors
                # and keep the live state; no progress is lost
                if replan is None:
                    log.error("cluster change (%s) with no replan callback", ev)
                    drain()
                    raise
                log.warning("cluster change: %s; replanning", ev)
                drain()            # an in-flight save finishes under the old plan
                train_step, plan = replan(ev)
                if isinstance(plan, dict) and plan.get("groups"):
                    log.warning("replanned: grid=%sx%s modes=%s%s", plan.get("n"), plan.get("m"),
                                [m for _, _, m in plan["groups"]],
                                " stages=%s" % (plan["stages"],) if plan.get("stages") else "")
                report.replans += 1
            except Exception as e:  # noqa: BLE001 - any step failure is retryable
                report.restarts += 1
                log.exception("step %d failed (%s); restart %d", step, e, report.restarts)
                if report.restarts > cfg.max_restarts:
                    drain()
                    raise
                try:
                    drain()
                except Exception:  # noqa: BLE001 - async save failure; restore the last commit
                    log.exception("async save failed during restart; restoring from last "
                                  "committed step")
                state = None       # free the failed run's state before the new one
                if mgr is not None and mgr.latest_step() is not None:
                    state, loaded = restore_latest()
                    step = loaded + 1
                else:
                    state = init_state(seed)
                    step = 0
                    report.steps_done = report.straggler_steps = 0
                    report.step_times.clear()
        drain()
    finally:
        watchdog.stop()
    return report
