"""Fault-injection harness for the training driver (DESIGN.md §10): the
port's own copy of ``repro/runtime/faults.py``, the same grammar and messages.

A *fault schedule* is a comma-separated spec of step-triggered faults -
the failure modes the paper's edge clusters actually exhibit (battery
death, thermal throttling, flaky storage):

    drop:jetson@5        device leaves at step 5  -> ClusterChange("drop")
    add:pi3@20           device joins at step 20  -> ClusterChange("add")
    slow:0.2@8           step 8 stalls 0.2s        (straggler detection)
    fail@9               step 9 raises             (checkpoint restart)
    ckpt-crash@10        next save: writer crashes once mid-write
                         (absorbed by retry_io's bounded backoff)
    ckpt-crash:9@10      ... crashes 9 times (exhausts retries; surfaces
                         from wait()/save(); prior checkpoint untouched)
    corrupt@12           flip bytes in a leaf of the latest checkpoint on
                         disk (restore falls back to the previous step)

``FaultInjector`` replays the schedule: the driver calls ``on_step(step)``
at the top of every step and each fault fires exactly once.  Device
changes are delivered by raising ``ClusterChange``, which the driver
catches and routes to its ``replan`` callback - the same path a real
device-health monitor would use.  Checkpoint faults arm hooks on the
``CheckpointManager`` (``bind()``ed by the driver): ``ckpt-crash`` uses
the manager's per-leaf ``write_fault`` hook, ``corrupt`` rewrites leaf
bytes behind the manifest's CRC so the integrity check trips.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Optional, Sequence, Union

log = logging.getLogger("repro_torch.runtime")

FAULT_KINDS = ("drop", "add", "slow", "fail", "ckpt-crash", "corrupt")


class FaultError(RuntimeError):
    """Injected transient step failure (``fail@k``) - retryable."""


class ClusterChange(Exception):
    """The device set changed: ``kind`` is "drop" or "add", ``device`` the
    profile name (or flat grid index as a string).  Raised out of the step
    loop so the driver can replan; carries no state - the live TrainState
    survives in the driver."""

    def __init__(self, kind: str, device: str, step: int):
        super().__init__(f"{kind}:{device} at step {step}")
        self.kind = kind
        self.device = device
        self.step = step


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str                              # one of FAULT_KINDS
    step: int                              # fires before this step runs
    arg: Union[str, float, int, None] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: {FAULT_KINDS}"
            )
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0; got {self.step}")
        if self.kind in ("drop", "add") and not self.arg:
            raise ValueError(f"{self.kind} fault needs a device name: "
                             f"'{self.kind}:<device>@<step>'")
        if self.kind == "slow" and (self.arg is None or float(self.arg) < 0):
            raise ValueError("slow fault needs seconds: 'slow:<sec>@<step>'")


def parse_fault_schedule(spec: str) -> list[Fault]:
    """Parse ``"drop:jetson@5,slow:0.2@8,ckpt-crash@10,corrupt@12"`` into
    Faults sorted by step.  Grammar per item: ``kind[:arg]@step``."""
    faults = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        if "@" not in item:
            raise ValueError(
                f"bad fault {item!r}: expected 'kind[:arg]@step' "
                f"(e.g. 'drop:jetson@5')"
            )
        head, _, step_s = item.rpartition("@")
        try:
            step = int(step_s)
        except ValueError:
            raise ValueError(f"bad fault step {step_s!r} in {item!r}") from None
        kind, _, arg_s = head.partition(":")
        arg: Union[str, float, int, None] = arg_s or None
        if kind == "slow":
            arg = float(arg_s)
        elif kind == "ckpt-crash":
            arg = int(arg_s) if arg_s else 1     # number of crashing attempts
        faults.append(Fault(kind, step, arg))
    return sorted(faults, key=lambda f: f.step)


def make_write_crash(times: int = 1, leaf: int = 0) -> Callable[[int], None]:
    """A ``CheckpointManager.write_fault`` hook that raises on leaf index
    ``leaf`` for the first ``times`` write attempts, then disarms - the
    mid-write kill whose partial tmp dir must never shadow the committed
    latest checkpoint."""
    remaining = [times]

    def hook(leaf_index: int) -> None:
        if remaining[0] > 0 and leaf_index == leaf:
            remaining[0] -= 1
            raise IOError(
                f"injected writer crash (leaf {leaf_index}, "
                f"{remaining[0]} more armed)"
            )

    return hook


def corrupt_leaf(ckpt_dir: str, step: int, leaf: int = 0) -> str:
    """Flip bytes in the ``leaf``-th .npy file of checkpoint ``step``
    (sorted file order), leaving the manifest CRC stale - returns the
    corrupted file's path."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    npys = sorted(f for f in os.listdir(d) if f.endswith(".npy"))
    if not npys:
        raise FileNotFoundError(f"no leaf files in {d}")
    path = os.path.join(d, npys[leaf % len(npys)])
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 0xFF]))
    return path


class FaultInjector:
    """Replays a fault schedule against the driver.  Each fault fires
    exactly once, at the first ``on_step(step)`` with ``step >= fault.step``
    (so faults scheduled inside a replayed/skipped range still fire)."""

    def __init__(
        self,
        schedule: Union[str, Sequence[Fault]],
        *,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.faults = (
            parse_fault_schedule(schedule)
            if isinstance(schedule, str)
            else sorted(schedule, key=lambda f: f.step)
        )
        self.fired: list[Fault] = []
        self._sleep = sleep
        self._mgr = None
        self._writer = True

    def bind(self, mgr, *, writer: bool = True) -> "FaultInjector":
        """Attach the CheckpointManager that ckpt-crash/corrupt faults act
        on (the driver calls this before the step loop).  A rank that
        writes no checkpoint (``writer=False``: every rank but 0 of a run
        on ranks) binds None, and its ckpt-crash/corrupt faults are marked
        fired without acting: they act on rank 0's writer and files."""
        self._mgr, self._writer = mgr, writer
        return self

    def skip(self, fired: int) -> None:
        """Mark the schedule's first ``fired`` faults fired without acting
        on them: a rank that idled while the active ranks replayed them
        comes back level with them (the faults fire in schedule order, so
        the fired ones are always a prefix)."""
        self.fired = list(self.faults[:fired])

    @property
    def pending(self) -> list[Fault]:
        return [f for f in self.faults if f not in self.fired]

    def on_step(self, step: int) -> None:
        """Fire every not-yet-fired fault with ``fault.step <= step``.
        Raising faults (drop/add/fail) mark themselves fired *before*
        raising, so the retried step does not re-trigger them."""
        for f in list(self.faults):
            if f in self.fired or f.step > step:
                continue
            self.fired.append(f)
            log.warning("fault injection: %s:%s at step %d", f.kind, f.arg, step)
            if f.kind == "slow":
                self._sleep(float(f.arg))
            elif f.kind == "fail":
                raise FaultError(f"injected step failure at step {step}")
            elif f.kind in ("ckpt-crash", "corrupt") and not self._writer:
                continue
            elif f.kind == "ckpt-crash":
                if self._mgr is None:
                    raise RuntimeError("ckpt-crash fault needs bind(mgr)")
                self._mgr.write_fault = make_write_crash(int(f.arg))
            elif f.kind == "corrupt":
                if self._mgr is None:
                    raise RuntimeError("corrupt fault needs bind(mgr)")
                latest = self._mgr.latest_step()
                if latest is None:
                    log.warning("corrupt fault at step %d: no checkpoint yet", step)
                else:
                    path = corrupt_leaf(self._mgr.dir, latest)
                    log.warning("fault injection: corrupted %s", path)
            else:  # drop / add
                raise ClusterChange(f.kind, str(f.arg), step)
