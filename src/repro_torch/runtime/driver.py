"""Serving driver: ``run_serving`` under a watchdog, with a ``ServeReport``.

The serving part of ``repro/runtime/driver.py``; the fault-tolerant
training driver is later work (ROADMAP A.15).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Optional

log = logging.getLogger("repro_torch.runtime")


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
