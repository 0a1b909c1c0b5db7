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

On ranks (``group``: a ``parallel/dist.py:TileGroup``), ``run_training``
runs the same loop on every rank of the launched world, by rules every
rank computes alike (``_run_on_ranks``):

  - the state is replicated: rank 0's params broadcast at init, the
    gradients all-reduced before the update, so every leaf is the same on
    every active rank.  Rank 0 alone writes checkpoints (the other ranks
    never touch the directory) and alone restores one, then broadcasts the
    step it loaded and every leaf to the active ranks;
  - before each step the active ranks agree, with one 4-byte all-reduce
    (MAX, ``dist.agree``), on what their ``faults`` and ``fault_hook``
    raised: nothing, a failed step (every rank restarts from rank 0's
    restore) or a cluster change (every rank replans).  Only what is raised
    before the step's first collective is agreed; a failure inside a step
    (a collective included) is raised on its rank as it is, and the other
    ranks end through the backend's timeout;
  - a replan runs on every launched rank: the rank that saw the change
    speaks at the world's meeting (``dist.meet``), every rank calls
    ``replan`` (which regroups the group onto the survivors, ranks 0 ..
    W'-1: ``dist.survivors``), and the ranks past W' idle at the next
    meeting, with no step and no watchdog.  A replan onto more ranks brings
    idle ones back, and each takes the live state by rank 0's broadcast;
  - at the run's end rank 0 calls the last meeting, every rank leaves, and
    the group is the whole world again.
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
from repro_torch.runtime.faults import ClusterChange, FaultError, FaultInjector

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


def _account(report: DriverReport, cfg: DriverConfig, step: int, t0: float, metrics: dict,
             watchdog: Watchdog) -> None:
    """A finished step into the report: its metrics read back to the host,
    its time since ``t0``, the watchdog's beat, the periodic log line and
    the straggler count against the rolling median."""
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
    group: Any = None,
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
    ``state_shardings`` have no meaning on one card.

    ``group`` runs the loop on ranks (the module docstring): every launched
    rank calls ``run_training`` with the same arguments; ``replan(event)``
    then runs on every launched rank, regroups ``group`` onto the
    survivors, and returns ``(None, manifest)`` on a rank left idle."""
    if cfg.resume not in ("auto", "always", "never"):
        raise ValueError(f"resume must be auto|always|never; got {cfg.resume!r}")
    if group is not None:
        return _run_on_ranks(init_state=init_state, train_step=train_step,
                             make_batch=make_batch, steps=steps, cfg=cfg, seed=seed,
                             fault_hook=fault_hook, faults=faults, replan=replan, plan=plan,
                             device=device, group=group)
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
                _account(report, cfg, step, t0, metrics, watchdog)
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


# ---------------------------------------------------------------------------
# The loop on ranks
# ---------------------------------------------------------------------------

# what a rank's faults raised before a step, agreed as ``code << 16 | 0xFFFF
# - rank`` (the highest code wins; among the ranks that saw a cluster
# change, the lowest rank speaks at the meeting)
NONE, FAIL, CHANGE = 0, 1, 2
# a meeting's message: its kind, the step, the faults fired, the event
REPLAN, END, ABORT = 1, 2, 3
_EVENTS = ("drop", "add")


def _meeting(kind: int, step: int = 0, fired: int = 0, ev: ClusterChange | None = None):
    words = [kind, step, fired]
    if ev is not None:
        name = ev.device.encode()
        words += [_EVENTS.index(ev.kind), len(name), *name]
    return words


def _event_of(words: list[int]) -> ClusterChange:
    n = words[4]
    return ClusterChange(_EVENTS[words[3]], bytes(words[5:5 + n]).decode(), words[1])


def _leaves(state) -> list:
    from repro_torch.ckpt.manager import map_with_path

    out = []
    map_with_path(lambda _, x: out.append(x), state)
    return out


def _share_state(group, state, role: str):
    """Rank 0's ``state`` on every active rank: each tensor leaf broadcast
    into the rank's own (the other ranks pass a state of the same
    structure, whose tensors receive it), int leaves alike; -> the state.
    ``role`` names it in the record: ``restore`` or ``return``."""
    from repro_torch.ckpt.manager import map_with_path
    from repro_torch.parallel.dist import broadcast_

    tensors = [x for x in _leaves(state) if isinstance(x, torch.Tensor)]
    ints = [x for x in _leaves(state) if not isinstance(x, torch.Tensor)]
    broadcast_(group, tensors, role=role)
    if not ints:
        return state
    t = torch.tensor([int(x) for x in ints], dtype=torch.int64, device=group.device)
    broadcast_(group, [t], role=role)
    got = iter(t.tolist())
    return map_with_path(lambda _, x: x if isinstance(x, torch.Tensor) else next(got), state)


def _meta_like(state):
    """The structure of a live state, each tensor an empty ``meta`` one."""
    from repro_torch.ckpt.manager import map_with_path

    return map_with_path(lambda _, x: torch.empty(x.shape, dtype=x.dtype, device="meta")
                         if isinstance(x, torch.Tensor) else x, state)


def _run_on_ranks(*, init_state, train_step, make_batch, steps, cfg, seed, fault_hook, faults,
                  replan, plan, device, group) -> DriverReport:
    """``run_training`` on the ranks of ``group`` (the module docstring)."""
    from repro_torch.parallel import dist as tdist

    if group.active != group.world:
        raise ValueError(f"a run starts on the whole world: {group.active} of {group.world} "
                         "ranks are active")
    writer = group.rank == 0
    if cfg.ckpt_dir is None and faults is not None and any(
            f.kind in ("ckpt-crash", "corrupt") for f in faults.faults):
        raise ValueError("ckpt-crash and corrupt faults act on checkpoints: give a ckpt_dir")
    mgr = None
    if cfg.ckpt_dir is not None and writer:
        mgr = CheckpointManager(cfg.ckpt_dir, io_retries=cfg.io_retries,
                                io_backoff=cfg.io_backoff)
    if faults is not None:
        faults.bind(mgr, writer=writer)
    report = DriverReport()

    def decide(code: int) -> int:
        """Rank 0's ``code`` on every active rank (a 4-byte broadcast)."""
        t = torch.tensor([code], dtype=torch.int32, device=group.device)
        tdist.broadcast_(group, [t], role="restore")
        return int(t.item())

    def drain():
        if mgr is not None:
            mgr.wait()

    def restore(live):
        """Rank 0 restores the newest loadable checkpoint (into the
        structure of its ``live`` state) and broadcasts the step it loaded
        and every leaf; -> (state, loaded step), or (``live``, -1) where
        there is none.  Every active rank calls it."""
        got, loaded = None, -1
        if mgr is not None:
            try:
                if mgr.latest_step() is not None:
                    like = _meta_like(live)
                    dev = device if device is not None else next(
                        x.device for x in _leaves(live) if isinstance(x, torch.Tensor))
                    live = None          # free rank 0's copy before the restore
                    got, loaded = mgr.restored_step(like, device=dev)
            except BaseException:
                decide(-2)               # the other ranks raise with it
                raise
        loaded = decide(loaded)
        if loaded == -2:
            raise RuntimeError("rank 0 could not restore a checkpoint (its error is rank 0's)")
        if loaded < 0:
            return live, -1
        return _share_state(group, got if writer else live, "restore"), loaded

    def local_code(step):
        """What this rank's faults raise before ``step``: (code, the
        exception)."""
        try:
            if faults is not None:
                faults.on_step(step)
            if fault_hook is not None:
                fault_hook(step)
        except ClusterChange as ev:
            return CHANGE, ev
        except Exception as e:  # noqa: BLE001 - any injected failure restarts every rank
            return FAIL, e
        return NONE, None

    # resume: rank 0 decides, every rank takes the state it loads
    found = 0
    if cfg.ckpt_dir is not None and cfg.resume != "never":
        found = decide(int(mgr is not None and mgr.latest_step() is not None))
        if cfg.resume == "always" and not found:
            raise FileNotFoundError(f"resume='always' but no checkpoint in {cfg.ckpt_dir}")
    state = init_state(seed)             # every rank: rank 0's params, the structure
    step = 0
    if found:
        state, loaded = restore(state)
        report.resumed_step, step = loaded, loaded + 1
        log.info("restored checkpoint at step %d", loaded)
    watchdog = Watchdog(cfg.hang_timeout)

    def replanned(ev: ClusterChange, at: int, fired: int):
        """Every launched rank: the replan onto the survivors; a rank that
        returns takes the live state."""
        nonlocal state, train_step, plan, step, watchdog
        was, before = group.is_active, group.active
        drain()                          # an in-flight save finishes under the old plan
        new_step, new_plan = replan(ev)
        report.replans += 1
        if isinstance(new_plan, dict) and new_plan.get("groups"):
            log.warning("replanned: grid=%sx%s modes=%s dist=%d", new_plan.get("n"),
                        new_plan.get("m"), [m for _, _, m in new_plan["groups"]], group.active)
        train_step, plan, step = new_step, new_plan, at
        if group.is_active and not was:
            if faults is not None:
                faults.skip(fired)
            watchdog = Watchdog(cfg.hang_timeout)
        if group.is_active and group.active > before:
            state = _share_state(group, state, "return")
        if not group.is_active and was:
            watchdog.stop()
            watchdog = None

    try:
        while True:
            if not group.is_active:
                words = tdist.meet(group, None)
                if words[0] == END:
                    break
                if words[0] == ABORT:
                    raise RuntimeError(f"the active ranks ended the run at step {words[1]}")
                replanned(_event_of(words), words[1], words[2])
                continue
            if step >= steps:
                drain()
                tdist.meet(group, _meeting(END, step) if writer else None)
                break
            t0 = time.monotonic()
            code, exc = local_code(step)
            agreed = tdist.agree(group, code << 16 | ((0xFFFF - group.rank) if code == CHANGE
                                                      else 0))
            code, src = agreed >> 16, 0xFFFF - (agreed & 0xFFFF)
            if code == CHANGE:
                fired = len(faults.fired) if faults is not None else 0
                words = tdist.meet(group, _meeting(REPLAN, step, fired, exc)
                                   if group.rank == src else None)
                ev = exc if group.rank == src else _event_of(words)
                if replan is None:
                    log.error("cluster change (%s) with no replan callback", ev)
                    drain()
                    raise ev
                log.warning("cluster change: %s; replanning", ev)
                replanned(ev, step, words[2])
                continue
            if code == FAIL:
                report.restarts += 1
                log.error("step %d failed on a rank (%s); restart %d", step,
                          exc if exc is not None else "agreed", report.restarts)
                if report.restarts > cfg.max_restarts:
                    drain()
                    tdist.meet(group, _meeting(ABORT, step) if writer else None)
                    raise exc if exc is not None else FaultError(
                        f"step {step} failed on another rank; restarts exhausted")
                if mgr is not None:
                    try:
                        drain()
                    except Exception:  # noqa: BLE001 - async save failure; restore the last commit
                        log.exception("async save failed during restart; restoring from last "
                                      "committed step")
                state, loaded = restore(state)
                if loaded >= 0:
                    step = loaded + 1
                else:
                    state = init_state(seed)
                    step = 0
                    report.steps_done = report.straggler_steps = 0
                    report.step_times.clear()
                continue
            try:
                state, metrics = train_step(state, make_batch(step))
            except BaseException:
                drain()
                raise
            _account(report, cfg, step, t0, metrics, watchdog)
            if mgr is not None and ((step + 1) % cfg.ckpt_every == 0 or step + 1 == steps):
                mgr.save(step, state, blocking=not cfg.async_ckpt, plan=plan)
            step += 1
        drain()
    finally:
        if watchdog is not None:
            watchdog.stop()
    if group.active < group.world:
        tdist.regroup(group, group.world)
    return report
