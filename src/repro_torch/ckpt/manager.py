"""Checkpointing with the reference's file format (``repro/ckpt/manager.py``,
DESIGN.md §10): partition-independent save and restore, async write, atomic
commit, retention, integrity checks and fallback to an older step.

Format, byte for byte the reference's: one ``.npy`` per state leaf, named by
``_sanitize`` of the leaf's path, plus ``manifest.json`` with ``version``,
``step``, an optional ``plan`` (``core.fusion.plan_manifest``) and, per leaf,
its ``path``, ``file``, ``shape``, ``dtype`` and the CRC-32 of the file's
bytes.  A leaf's path is what the reference's ``compat.keystr_slash`` spells
for the same place in its ``TrainState``: NamedTuple fields by name, dict
keys (visited in sorted order, as JAX flattens dicts), list indices, joined
by ``/`` - ``params/0/w``, ``opt/m/0/w``, ``opt/t``, ``step``; ``None`` (the
``ef`` of a run without compression) is no leaf.  The port's Python ints
(``TrainState.step``, the optimizers' ``"t"``) are written as 0-d ``int32``,
as JAX holds them, and read back as ints.  So a checkpoint either package
writes restores in the other.

bfloat16 (ROADMAP C.6): JAX's ``np.save`` of a bf16 array writes the header
``'<V2'`` (ml_dtypes' bfloat16) under manifest dtype ``"bfloat16"``, and the
reference's restore cannot read that back.  The port writes the same header
and bits without ml_dtypes and reads such a leaf by viewing its bits as
``torch.bfloat16``.

Params and optimizer state are stored in their global (untiled) form, so a
checkpoint taken under any plan restores under any other.  Restored tensor
leaves land on the device the caller names, or on the device of the leaf of
``like`` they replace; a leaf of an abstract (``meta``) state needs the
device named - nothing lands on the CPU by default.

Atomicity: a save writes ``step_XXXXXXXX.tmp``, fsyncs the manifest, then
renames - a killed save never corrupts the latest checkpoint.  Transient IO
errors are retried with doubling backoff (``retry_io``); an async writer's
failure is re-raised from ``wait()`` or the next ``save()``; ``restore()``
checks every leaf against ``like`` (``CheckpointError`` naming the leaf) and
its CRC, and skips a corrupt newest step for the previous retained one.
"""
from __future__ import annotations

import json
import logging
import os
import re
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch

log = logging.getLogger("repro_torch.ckpt")

MANIFEST_VERSION = 2

# torch dtype -> the numpy dtype name the manifest records
_DTYPE_NAMES = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
    torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_BF16_DESCR = "<V2"      # what np.save writes for ml_dtypes' bfloat16 (C.6)


class CheckpointError(RuntimeError):
    """Structural checkpoint problem: the stored state does not match the
    requested structure (missing leaf, shape/dtype mismatch).  Not retried
    and not subject to previous-step fallback."""


class CheckpointCorruptError(CheckpointError):
    """No retained checkpoint step could be loaded intact."""


def _sanitize(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", path)


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """``fn(path, leaf)`` over the leaves of a tree of NamedTuples, dicts,
    lists and tuples, keeping its structure; ``None`` is no leaf.  Leaves
    are visited in JAX's flattening order (dict keys sorted)."""

    def go(prefix: str, x):
        def sub(k):
            return f"{prefix}/{k}" if prefix else str(k)

        if x is None:
            return None
        if _is_namedtuple(x):
            return type(x)(*(go(sub(f), getattr(x, f)) for f in x._fields))
        if isinstance(x, dict):
            done = {k: go(sub(k), x[k]) for k in sorted(x)}
            return {k: done[k] for k in x}
        if isinstance(x, (list, tuple)):
            return type(x)(go(sub(i), v) for i, v in enumerate(x))
        return fn(prefix, x)

    return go("", tree)


def _host_copy(x):
    """A leaf's host snapshot, copied now: later in-place updates of the
    live state (the LM step's) must not reach a write still in flight."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).contiguous()
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True)
    if isinstance(x, (bool, np.bool_)) or not isinstance(x, (int, float, np.generic)):
        raise TypeError(f"cannot checkpoint a leaf of type {type(x).__name__}")
    return x


def _save_leaf(fpath: str, x) -> tuple[list, str]:
    """Write one host leaf as the reference's ``np.save`` would; returns its
    (shape, manifest dtype)."""
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        with open(fpath, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": tuple(x.shape)})
            f.write(x.view(torch.int16).numpy().tobytes())
        return list(x.shape), "bfloat16"
    if isinstance(x, torch.Tensor):
        arr = x.numpy()
    elif isinstance(x, int):
        if not -2**31 <= x < 2**31:
            raise ValueError(f"int leaf {x} does not fit the int32 it is stored as")
        arr = np.asarray(x, np.int32)
    else:
        arr = np.ascontiguousarray(x)
    np.save(fpath, arr)
    return list(arr.shape), str(arr.dtype)


def leaf_meta(x) -> tuple[tuple, str]:
    """(shape, manifest dtype) a leaf of ``like`` asks for."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), _DTYPE_NAMES[x.dtype]
    if isinstance(x, int) and not isinstance(x, bool):
        return (), "int32"
    arr = np.asarray(x)
    return tuple(arr.shape), str(arr.dtype)


def _load_leaf(fpath: str, entry: dict, x, device):
    arr = np.load(fpath)
    if not isinstance(x, torch.Tensor):
        return int(arr) if isinstance(x, int) else arr
    if entry.get("dtype") == "bfloat16":
        # C.6: the file holds bf16 bits under a void header
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device if device is not None else x.device)


def _check_device(like: Any, device) -> None:
    """An abstract (``meta``) leaf has no device to land on: the caller
    must name one, so a restore never falls back to the CPU unasked."""
    if device is not None:
        return
    metas = []
    map_with_path(lambda p, x: metas.append(p)
                  if isinstance(x, torch.Tensor) and x.device.type == "meta" else None, like)
    if metas:
        raise ValueError(
            f"restoring into meta leaves ({metas[0]!r}, ...) needs device=: the run's device")


def retry_io(
    fn: Callable[[], Any],
    *,
    retries: int = 3,
    backoff: float = 0.05,
    sleep: Callable[[float], None] = time.sleep,
    what: str = "checkpoint IO",
) -> Any:
    """Run ``fn`` with bounded retry and exponential backoff (the delay
    doubles per attempt).  ``retries`` counts *re*-tries: fn runs at most
    ``retries + 1`` times.  ``sleep`` is injectable so tests can read the
    backoff sequence without waiting it out."""
    attempt = 0
    while True:
        try:
            return fn()
        except CheckpointError:
            raise  # structural - retrying cannot fix it
        except Exception as e:  # noqa: BLE001 - any IO failure is retryable
            attempt += 1
            if attempt > retries:
                raise
            delay = backoff * (2 ** (attempt - 1))
            log.warning("%s failed (%s: %s); retry %d/%d in %.3fs",
                        what, type(e).__name__, e, attempt, retries, delay)
            sleep(delay)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        keep: int = 3,
        *,
        io_retries: int = 3,
        io_backoff: float = 0.05,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.dir = directory
        self.keep = keep
        self.io_retries = io_retries
        self.io_backoff = io_backoff
        self._sleep = sleep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None
        self._async_exc: Optional[BaseException] = None
        # fault-injection hook: called as write_fault(leaf_index) inside the
        # leaf-write loop of every save attempt; may raise to simulate a
        # mid-write crash (runtime.faults arms it)
        self.write_fault: Optional[Callable[[int], None]] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, *, blocking: bool = True, plan: Any = None) -> None:
        """Write checkpoint ``step``.  ``plan`` is an optional JSON-
        serializable plan manifest stored with the leaves (metadata; never
        needed to restore them).

        The host snapshot is taken here, before the call returns, whether
        or not it blocks: each tensor is copied off its device, so the
        caller may update the state in place at once.  ``blocking=False``
        hands only the file writing to a thread; its failure is re-raised
        from ``wait()`` or the next ``save()``."""
        self.wait()  # re-raises a prior async failure before starting anew
        host_state = map_with_path(lambda p, x: _host_copy(x), state)
        if blocking:
            self._write_with_retry(step, host_state, plan)
        else:
            def run():
                try:
                    self._write_with_retry(step, host_state, plan)
                except BaseException as e:  # noqa: BLE001 - surfaced in wait()
                    self._async_exc = e

            self._async_thread = threading.Thread(target=run, daemon=True)
            self._async_thread.start()

    def wait(self) -> None:
        """Join any in-flight async save and re-raise its failure, if it had
        one.  The latest committed checkpoint is untouched by a failed save
        (the rename happens only after a complete write)."""
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None
        if self._async_exc is not None:
            exc, self._async_exc = self._async_exc, None
            raise exc

    def _write_with_retry(self, step: int, host_state: Any, plan: Any) -> None:
        retry_io(lambda: self._write(step, host_state, plan), retries=self.io_retries,
                 backoff=self.io_backoff, sleep=self._sleep, what=f"checkpoint save step {step}")

    def _write(self, step: int, host_state: Any, plan: Any = None) -> None:
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)  # stale attempt (crash or retry); rebuild
        os.makedirs(tmp)
        manifest = {"version": MANIFEST_VERSION, "step": step, "leaves": []}
        if plan is not None:
            manifest["plan"] = plan
        counter = [0]

        def leaf(path, x):
            if self.write_fault is not None:
                self.write_fault(counter[0])
            counter[0] += 1
            name = _sanitize(path) or "root"
            fpath = os.path.join(tmp, name + ".npy")
            shape, dtype = _save_leaf(fpath, x)
            manifest["leaves"].append({"path": path, "file": name + ".npy", "shape": shape,
                                       "dtype": dtype, "crc32": _crc32_file(fpath)})
            return x

        map_with_path(leaf, host_state)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._retain()

    def _retain(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def read_manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    def plan_of(self, step: Optional[int] = None) -> Optional[dict]:
        """The plan manifest stored with checkpoint ``step`` (default: the
        latest), or None when it was saved without one."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return self.read_manifest(step).get("plan")

    @staticmethod
    def _validate_manifest(manifest: dict, like: Any, step: int) -> dict:
        """Every leaf of ``like`` must be recorded with its shape and dtype.
        Returns {path: entry}; raises ``CheckpointError`` naming the leaf."""
        entries = {e["path"]: e for e in manifest.get("leaves", [])}

        def check(p, x):
            e = entries.get(p)
            if e is None:
                raise CheckpointError(
                    f"checkpoint step {step} has no leaf {p!r}; stored leaves: {sorted(entries)}")
            want_shape, want_dtype = leaf_meta(x)
            if "shape" in e and tuple(e["shape"]) != want_shape:
                raise CheckpointError(
                    f"leaf {p!r} of checkpoint step {step} has shape {tuple(e['shape'])}, "
                    f"expected {want_shape} - the stored state was trained on a different "
                    "model geometry")
            if "dtype" in e and e["dtype"] != want_dtype:
                raise CheckpointError(
                    f"leaf {p!r} of checkpoint step {step} has dtype {e['dtype']}, "
                    f"expected {want_dtype}")
            return x

        map_with_path(check, like)
        return entries

    def _load_step(self, step: int, like: Any, device=None) -> Any:
        """Load one step with full validation: a manifest that matches
        ``like`` (``CheckpointError`` otherwise - no fallback) and every
        leaf file present with an intact checksum (any other failure marks
        the step corrupt and propagates for fallback)."""
        d = self._step_dir(step)
        try:
            manifest = self.read_manifest(step)
        except (OSError, json.JSONDecodeError) as e:
            raise IOError(f"unreadable manifest for step {step}: {e}") from e
        entries = self._validate_manifest(manifest, like, step)

        def leaf(p, x):
            e = entries[p]
            fpath = os.path.join(d, e["file"])
            if not os.path.exists(fpath):
                raise IOError(f"leaf file {e['file']} missing from step {step}")
            if "crc32" in e and _crc32_file(fpath) != e["crc32"]:
                raise IOError(f"checksum mismatch on leaf {p!r} ({e['file']}) of step {step} - "
                              "file corrupted on disk")
            return _load_leaf(fpath, e, x, device)

        return map_with_path(leaf, like)

    def restore(self, like: Any, step: Optional[int] = None, device=None) -> Any:
        """Restore into the structure of ``like`` (tensors of any device,
        ``meta`` included, ints and numpy arrays).  Tensor leaves land on
        ``device``, or on their ``like`` leaf's device; the reference's
        ``shardings`` have no meaning on one card.

        An explicit ``step`` is loaded exactly (corruption raises).  With
        ``step=None`` a corrupted or unreadable newest step is logged and
        skipped for the previous retained one."""
        _check_device(like, device)
        if step is not None:
            return retry_io(lambda: self._load_step(step, like, device), retries=self.io_retries,
                            backoff=self.io_backoff, sleep=self._sleep,
                            what=f"checkpoint restore step {step}")
        return self.restored_step(like, device)[0]

    def restored_step(self, like: Any, device=None) -> tuple[Any, int]:
        """``restore()`` newest-first with fallback, also returning the step
        actually loaded, so a caller replaying a data stream knows where to
        resume - it may be earlier than ``latest_step()``."""
        _check_device(like, device)
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        last_err: Optional[Exception] = None
        for s in reversed(steps):
            try:
                return self._load_step(s, like, device), s
            except CheckpointError:
                raise
            except Exception as e:  # noqa: BLE001
                last_err = e
                log.warning("checkpoint step %d unusable (%s: %s); falling back to previous "
                            "retained step", s, type(e).__name__, e)
        raise CheckpointCorruptError(
            f"no retained checkpoint in {self.dir} is loadable (tried steps {steps}; last "
            f"error: {last_err})")
