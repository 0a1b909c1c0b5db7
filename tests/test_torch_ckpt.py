"""The port's checkpoint manager and fault-tolerant driver
(``repro_torch/ckpt/manager.py``, ``repro_torch/runtime/driver.py``).

- every case of ``tests/test_ckpt_runtime.py`` on the port: restart,
  atomicity, retention, straggler count, restore onto a named device,
  async-failure surfacing, manifest validation naming the leaf, checksum
  fallback, plan manifests and the resume policies;
- the file format against the reference's, both ways, on a YOLO 4-layer
  ``TrainState`` at 32 px with SGD and int8 error feedback: JAX writes and
  the port restores bit for bit (its ints as ints); the port writes the same
  ``.npy`` bytes, CRCs and manifest, and JAX restores them bit for bit;
- bfloat16 (ROADMAP C.6): the reference cannot restore a bf16 leaf it
  wrote; the port restores it bit for bit and writes the same bytes;
- the port's own cases: a restore into an abstract (``meta``) state needs
  the run's device, the async snapshot holds the values at the save under
  the LM step that updates the state in place, and resume and restart on a
  tiled plan are bitwise equal to the uninterrupted run.
"""
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import manager as jmanager
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.core import fusion as jfu
from repro.launch.mesh import make_tile_mesh as jax_mesh
from repro.models.tiled_cnn import TiledCNNArch as JArch
from repro.models.yolo import l2_loss_local as jax_l2
from repro.models.yolo import yolov2_16_layers as jax_yolo_layers
from repro.train import trainer as jtrain
from repro_torch.ckpt.manager import (
    CheckpointCorruptError,
    CheckpointError,
    CheckpointManager,
    map_with_path,
    retry_io,
)
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.tiling import Group
from repro_torch.models.yolo import make_yolo_tiled_arch
from repro_torch.runtime.driver import DriverConfig, run_training
from repro_torch.runtime.faults import FaultInjector, corrupt_leaf, make_write_crash
from repro_torch.train.trainer import abstract_of, abstract_state, make_train_step


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _state(v=0.0):
    return {"w": torch.full((4, 4), float(v)), "step": int(v)}


def leaf_paths(tree):
    """The paths of ``tree``'s leaves, in the order a save writes them."""
    out = []
    map_with_path(lambda p, x: out.append(p), tree)
    return out


def _like(make):
    """The structure a restore fills: ``make()``'s shapes and dtypes on the
    meta device (the reference's ``jax.eval_shape``)."""
    return abstract_of(lambda _: make())[0]


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"a": torch.arange(6).reshape(2, 3), "nested": {"b": torch.tensor(3.5)}}
    mgr.save(7, state)
    out = mgr.restore(_like(lambda: state), device="cpu")
    assert torch.equal(out["a"], state["a"])
    assert float(out["nested"]["b"]) == 3.5
    assert mgr.latest_step() == 7


def test_retention_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4]


def test_async_save_waits(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 1


def test_interrupted_save_never_corrupts(tmp_path):
    """A .tmp dir from a killed save is ignored by restore (atomic rename)."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1.0))
    os.makedirs(tmp_path / "step_00000002.tmp")
    with open(tmp_path / "step_00000002.tmp" / "partial.npy", "w") as f:
        f.write("garbage")
    assert mgr.latest_step() == 1
    out = mgr.restore(_like(_state), device="cpu")
    assert float(out["w"][0, 0]) == 1.0 and out["step"] == 1


def _add_step(state, batch):
    w = state["w"] + batch["x"].mean()
    return {"w": w, "step": state["step"] + 1}, {"loss": torch.sum(w)}


def test_driver_completes_and_checkpoints(tmp_path):
    calls = []

    def make_batch(step):
        calls.append(step)
        return {"x": torch.full((2,), 1.0)}

    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=4, async_ckpt=False)
    report = run_training(init_state=lambda s: _state(0.0), train_step=_add_step,
                          make_batch=make_batch, steps=10, cfg=cfg)
    assert report.steps_done == 10 and report.restarts == 0
    assert calls == list(range(10))
    assert CheckpointManager(str(tmp_path)).all_steps() == [3, 7, 9]   # and the final step


def test_driver_restarts_from_checkpoint_on_failure(tmp_path):
    """A failure at step 6 restores the step-3 checkpoint and replays the
    stream: the final state is 10 steps of correct arithmetic."""
    boom = {"armed": True}

    def fault_hook(step):
        if step == 6 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected preemption")

    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=4, async_ckpt=False)
    report = run_training(init_state=lambda s: _state(0.0), train_step=_add_step,
                          make_batch=lambda s: {"x": torch.full((2,), float(s))},
                          steps=10, cfg=cfg, fault_hook=fault_hook)
    assert report.restarts == 1
    assert report.steps_done == 10 + 2        # steps 4 and 5 ran twice
    out = CheckpointManager(str(tmp_path)).restore(_like(_state), device="cpu")
    assert float(out["w"][0, 0]) == pytest.approx(sum(range(10))) and out["step"] == 10


def test_driver_gives_up_after_max_restarts(tmp_path):
    def fault_hook(step):
        raise RuntimeError("always broken")

    cfg = DriverConfig(ckpt_dir=str(tmp_path), max_restarts=2, async_ckpt=False)
    with pytest.raises(RuntimeError, match="always broken"):
        run_training(init_state=lambda s: _state(), train_step=lambda s, b: (s, {"loss": 0.0}),
                     make_batch=lambda s: {}, steps=3, cfg=cfg, fault_hook=fault_hook)


def test_driver_straggler_detection(tmp_path):
    def train_step(state, batch):
        if state["step"] == 5:
            time.sleep(0.25)
        return {"w": state["w"], "step": state["step"] + 1}, {"loss": torch.tensor(0.0)}

    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=100, straggler_factor=3.0,
                       async_ckpt=False)
    report = run_training(init_state=lambda s: _state(), train_step=train_step,
                          make_batch=lambda s: {}, steps=12, cfg=cfg)
    assert report.straggler_steps >= 1


def test_elastic_restore_from_flat_arrays(tmp_path):
    """Checkpoints hold whole host arrays: a restore places them on the
    device it is given, whatever wrote them (the reference's explicit
    single-device sharding)."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(64.0).reshape(8, 8)}
    mgr.save(0, state)
    out = mgr.restore(_like(lambda: state), device=torch.device("cpu"))
    assert out["w"].device.type == "cpu" and torch.equal(out["w"], state["w"])
    again = mgr.restore({"w": torch.zeros(8, 8, dtype=torch.float32)})   # the like leaf's device
    assert torch.equal(again["w"], state["w"])


def test_restore_into_meta_needs_the_runs_device(tmp_path):
    """A leaf of an abstract state has no device to land on: the restore
    names none by default, rather than landing on the CPU unasked."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _state(1.0))
    with pytest.raises(ValueError, match="needs device="):
        mgr.restore(_like(_state))
    with pytest.raises(ValueError, match="needs device="):
        mgr.restored_step(_like(_state))


# ---------------------------------------------------------------------------
# async-save failure surfacing
# ---------------------------------------------------------------------------


def test_async_save_failure_reraised_from_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), io_retries=1, io_backoff=0.0)
    mgr.save(0, _state(1.0))
    d0 = tmp_path / "step_00000000"
    before = {f: (d0 / f).read_bytes() for f in os.listdir(d0)}
    mgr.write_fault = make_write_crash(times=10)      # outlives the retries
    mgr.save(1, _state(2.0), blocking=False)
    with pytest.raises(IOError, match="injected writer crash"):
        mgr.wait()
    assert mgr.latest_step() == 0
    assert {f: (d0 / f).read_bytes() for f in os.listdir(d0)} == before
    assert float(mgr.restore(_like(_state), device="cpu")["w"][0, 0]) == 1.0


def test_async_saves_hold_their_snapshots_under_thread_switching(tmp_path):
    """Back-to-back async saves of a tensor the caller updates in place
    right after each save, with the interpreter switching threads as often
    as it can: every checkpoint holds the value at its own save."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    mgr = CheckpointManager(str(tmp_path), keep=64)
    w = torch.zeros(64, 64)
    try:
        for s in range(32):
            w.add_(1.0)
            mgr.save(s, {"w": w, "step": s}, blocking=False)
        mgr.wait()
    finally:
        sys.setswitchinterval(interval)
    assert mgr.all_steps() == list(range(32))
    for s in range(32):
        out = mgr.restore({"w": torch.zeros(64, 64), "step": 0}, step=s)
        assert out["step"] == s and bool((out["w"] == s + 1).all()), s


def test_async_save_failure_reraised_from_next_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), io_retries=0, io_backoff=0.0)
    mgr.write_fault = make_write_crash(times=10)
    mgr.save(0, _state(), blocking=False)
    with pytest.raises(IOError, match="injected writer crash"):
        mgr.save(1, _state())


def test_one_shot_write_crash_absorbed_by_retry(tmp_path):
    mgr = CheckpointManager(str(tmp_path), io_retries=2, io_backoff=0.0)
    mgr.write_fault = make_write_crash(times=1)
    mgr.save(0, _state(3.0))
    assert mgr.latest_step() == 0
    assert float(mgr.restore(_like(_state), device="cpu")["w"][0, 0]) == 3.0


def test_retry_io_backoff_sequence():
    delays, calls = [], [0]

    def fn():
        calls[0] += 1
        raise OSError("disk flake")

    with pytest.raises(OSError):
        retry_io(fn, retries=3, backoff=0.1, sleep=delays.append)
    assert calls[0] == 4
    assert delays == pytest.approx([0.1, 0.2, 0.4])
    structural = [0]

    def fn2():
        structural[0] += 1
        raise CheckpointError("wrong model")

    with pytest.raises(CheckpointError):
        retry_io(fn2, retries=3, backoff=0.1, sleep=delays.append)
    assert structural[0] == 1


# ---------------------------------------------------------------------------
# manifest shapes/dtypes + validation errors naming the leaf
# ---------------------------------------------------------------------------


def test_manifest_records_shapes_dtypes_checksums(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": torch.zeros((4, 4)), "n": {"b": 3}})
    entries = {e["path"]: e for e in mgr.read_manifest(0)["leaves"]}
    assert entries["w"]["shape"] == [4, 4] and entries["w"]["dtype"] == "float32"
    assert entries["n/b"]["shape"] == [] and entries["n/b"]["dtype"] == "int32"
    assert all(isinstance(e["crc32"], int) for e in entries.values())


@pytest.mark.parametrize("saved,like,match", [
    ({"w": torch.zeros(2)}, {"w": torch.zeros(2), "extra": torch.zeros(3)}, "no leaf 'extra'"),
    ({"a": {"w": torch.zeros(2, 3)}}, {"a": {"w": torch.zeros(4, 4)}},
     r"'a/w'.*\(2, 3\).*\(4, 4\)"),
    ({"w": torch.zeros(2)}, {"w": torch.zeros(2, dtype=torch.int32)}, "'w'.*float32.*int32"),
    ({"t": torch.zeros(())}, {"t": 0}, "'t'.*float32.*int32"),
], ids=["missing_leaf", "shape_mismatch", "dtype_mismatch", "int_leaf_dtype"])
def test_restore_mismatch_names_path(tmp_path, saved, like, match):
    """The three ``test_restore_*_names_path`` cases of the reference, and
    an int leaf that the file holds as a float."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, saved)
    with pytest.raises(CheckpointError, match=match):
        mgr.restore(like, step=0)


def test_structural_mismatch_not_subject_to_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, {"w": torch.zeros(2, 3)})
    mgr.save(1, {"w": torch.zeros(2, 3)})
    with pytest.raises(CheckpointError):
        mgr.restore({"w": torch.zeros(9, 9)})


# ---------------------------------------------------------------------------
# checksum fallback
# ---------------------------------------------------------------------------


def test_corrupted_leaf_falls_back_to_previous_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), io_backoff=0.0)
    mgr.save(0, _state(1.0))
    mgr.save(1, _state(2.0))
    corrupt_leaf(str(tmp_path), 1)
    like = _like(_state)
    out, step = mgr.restored_step(like, device="cpu")
    assert step == 0 and float(out["w"][0, 0]) == 1.0
    assert float(mgr.restore(like, device="cpu")["w"][0, 0]) == 1.0
    with pytest.raises(IOError, match="checksum mismatch"):
        mgr.restore(like, step=1, device="cpu")


def test_all_steps_corrupt_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _state(1.0))
    mgr.save(1, _state(2.0))
    corrupt_leaf(str(tmp_path), 0)
    corrupt_leaf(str(tmp_path), 1)
    with pytest.raises(CheckpointCorruptError):
        mgr.restore(_like(_state), device="cpu")


def test_missing_leaf_file_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _state(1.0))
    mgr.save(1, _state(2.0))
    os.remove(tmp_path / "step_00000001" / "w.npy")
    out, step = mgr.restored_step(_like(_state), device="cpu")
    assert step == 0 and float(out["w"][0, 0]) == 1.0


# ---------------------------------------------------------------------------
# plan manifest storage + driver resume semantics
# ---------------------------------------------------------------------------


def test_plan_manifest_stored_and_read_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    plan = {"version": 1, "n": 2, "m": 2, "note": "stub"}
    mgr.save(3, _state(), plan=plan)
    assert mgr.plan_of() == plan and mgr.plan_of(3) == plan
    mgr.save(4, _state())
    assert mgr.plan_of(4) is None


def _toy_driver(tmp_path, steps, resume="auto", **kw):
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=2, async_ckpt=False, resume=resume)
    return run_training(init_state=lambda s: _state(0.0), train_step=_add_step,
                        make_batch=lambda s: {"x": torch.full((2,), float(s))},
                        steps=steps, cfg=cfg, **kw)


def test_driver_resume_never_starts_fresh(tmp_path):
    _toy_driver(tmp_path, 4)
    rep = _toy_driver(tmp_path, 4, resume="never")
    assert rep.resumed_step is None and rep.steps_done == 4


def test_driver_resume_always_requires_checkpoint(tmp_path):
    with pytest.raises(FileNotFoundError):
        _toy_driver(tmp_path, 4, resume="always")
    with pytest.raises(ValueError, match="auto|always|never"):
        _toy_driver(tmp_path, 4, resume="sometimes")


def test_driver_resume_falls_back_past_corrupt_latest(tmp_path):
    _toy_driver(tmp_path, 6)                         # ckpts at steps 1, 3, 5
    corrupt_leaf(str(tmp_path), 5)
    rep = _toy_driver(tmp_path, 8, resume="auto")
    assert rep.resumed_step == 3 and rep.steps_done == 4
    out = CheckpointManager(str(tmp_path)).restore(_like(_state), device="cpu")
    assert float(out["w"][0, 0]) == pytest.approx(sum(range(8))) and out["step"] == 8


# ---------------------------------------------------------------------------
# the reference's file format, both ways
# ---------------------------------------------------------------------------

HW = (32, 32)
TCFG = dict(lr=1e-3, optimizer="sgd", warmup=0, steps=4, grad_compression="int8")


def _jax_state(steps=1):
    """A JAX TrainState of the YOLO 4-layer stack after ``steps`` SGD
    steps with int8 error feedback (momentum, EF and counters nonzero)."""
    plan = jfu.build_stack_plan(HW, jax_yolo_layers()[:4], 1, 1)
    arch = JArch(plan=plan, mesh=jax_mesh(1, 1), loss_local=jax_l2)
    init_state, step = jtrain.make_train_step(arch, JParallel(grad_accum=2), JTrain(**TCFG))
    state = init_state(jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    for _ in range(steps):
        batch = {"x": rng.standard_normal((4, *HW, 3)).astype(np.float32),
                 "t": 0.05 * rng.standard_normal((4, 8, 8, 64)).astype(np.float32)}
        state, _ = jax.jit(step)(state, batch)
    return state


def _port_like():
    arch = make_yolo_tiled_arch(HW, 4, 1, 1, device="cpu")
    return abstract_state(arch, ParallelConfig(grad_accum=2), TrainConfig(**TCFG))


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_format_parity_jax_writes_port_restores_and_back(tmp_path):
    jstate = _jax_state()
    jmgr = jmanager.CheckpointManager(str(tmp_path / "jax"))
    jmgr.save(1, jstate)
    like = _port_like()
    leaves = leaf_paths(like)
    assert leaves == [e["path"] for e in jmgr.read_manifest(1)["leaves"]]
    assert {"params/0/w", "opt/m/0/w", "opt/t", "step", "ef/0/w"} <= set(leaves)
    state = CheckpointManager(str(tmp_path / "jax")).restore(like, device="cpu")
    # the counters back as the 0-d int32 tensors the port's state holds,
    # every tensor bit for bit
    assert state.step == int(jstate.step) == 1 and state.opt["t"] == 1
    assert all(isinstance(x, torch.Tensor) and x.shape == () and x.dtype == torch.int32
               for x in (state.step, state.opt["t"]))
    want = dict(zip(leaf_paths(jstate), jax.tree.leaves(jstate)))
    got = {}
    map_with_path(lambda p, x: got.__setitem__(p, x), state)
    assert set(got) == set(want)
    for p, x in got.items():
        if isinstance(x, torch.Tensor):
            dtype = torch.int32 if p in ("step", "opt/t") else torch.float32
            assert x.dtype == dtype and np.array_equal(x.numpy(), np.asarray(want[p])), p
    # the port writes the same bytes, CRCs and manifest
    CheckpointManager(str(tmp_path / "port")).save(1, state)
    a, b = _files(tmp_path / "jax" / "step_00000001"), _files(tmp_path / "port" / "step_00000001")
    assert a == b
    # and JAX restores the port's checkpoint bit for bit
    back = jmgr.__class__(str(tmp_path / "port")).restore(jax.eval_shape(lambda: jstate))
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert x.dtype == y.dtype and np.array_equal(np.asarray(x), np.asarray(y))


def test_leaf_paths_spell_the_references_keystr():
    """The path function over the port's trees equals ``keystr_slash`` over
    the reference's for the same places, in the same order, with ``None``
    (``ef`` off) no leaf."""
    from repro.compat import keystr_slash
    from repro_torch.train.trainer import TrainState

    jtree = {"b": [jnp.zeros(1), {"z": jnp.zeros(1), "a": jnp.int32(0)}], "a": jnp.zeros(2)}
    ttree = {"b": [torch.zeros(1), {"z": torch.zeros(1), "a": 0}], "a": torch.zeros(2)}
    jpaths = [keystr_slash(p) for p, _ in jax.tree_util.tree_leaves_with_path(jtree)]
    assert leaf_paths(ttree) == jpaths == ["a", "b/0", "b/1/a", "b/1/z"]
    st = TrainState([{"w": torch.zeros(1)}], {"m": [{"w": torch.zeros(1)}], "t": 0}, 0, None)
    assert leaf_paths(st) == ["params/0/w", "opt/m/0/w", "opt/t", "step"]


def test_reference_cannot_restore_its_own_bf16_leaf(tmp_path):
    """ROADMAP C.6: ``np.save`` writes a bf16 leaf under the header
    ``'<V2'``; the reference's restore reads it back as a void array, which
    JAX rejects, and no retained step is loadable."""
    mgr = jmanager.CheckpointManager(str(tmp_path), io_backoff=0.0)
    state = {"w": jnp.arange(4, dtype=jnp.bfloat16), "t": jnp.int32(3)}
    mgr.save(1, state)
    assert {e["path"]: e["dtype"] for e in mgr.read_manifest(1)["leaves"]}["w"] == "bfloat16"
    with pytest.raises(jmanager.CheckpointCorruptError):
        mgr.restore(jax.eval_shape(lambda: state))


def test_port_restores_a_jax_written_bf16_leaf_bitwise(tmp_path):
    """C.6 in the port: the JAX-written bf16 leaf reads back bit for bit
    (its bits viewed as ``torch.bfloat16``, no ml_dtypes), and the port
    writes the same file bytes and CRC."""
    vals = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    jstate = {"w": jnp.asarray(vals, dtype=jnp.bfloat16), "t": jnp.int32(3)}
    jmanager.CheckpointManager(str(tmp_path / "jax")).save(1, jstate)
    mgr = CheckpointManager(str(tmp_path / "jax"))
    out = mgr.restore({"w": torch.empty((3, 5), dtype=torch.bfloat16, device="meta"), "t": 0},
                      device="cpu")
    assert out["w"].dtype == torch.bfloat16 and out["t"] == 3
    assert np.array_equal(out["w"].view(torch.int16).numpy(),
                          np.asarray(jstate["w"]).view(np.int16))
    CheckpointManager(str(tmp_path / "port")).save(1, out)
    assert _files(tmp_path / "jax" / "step_00000001") == _files(tmp_path / "port" / "step_00000001")


# ---------------------------------------------------------------------------
# the port's own: async snapshot under an in-place step; bitwise resume
# ---------------------------------------------------------------------------


def _lm_bf16():
    import dataclasses

    from repro_torch.configs.qwen2_7b import reduced
    from repro_torch.models.registry import bundle_from_cfg

    cfg = dataclasses.replace(reduced(), dtype="bfloat16", param_dtype="bfloat16")
    return bundle_from_cfg(cfg, "cpu")


def _lm_batch(arch, step):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import place, synth_batch

    specs = arch.input_specs(ShapeConfig("t", 16, 2, "train"))
    return place(synth_batch(specs, arch.cfg, 0, step), arch.device)


def _same(a, b) -> bool:
    xs, ys = [], []
    map_with_path(lambda p, x: xs.append((p, x)), a)
    map_with_path(lambda p, x: ys.append((p, x)), b)
    return [p for p, _ in xs] == [p for p, _ in ys] and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for (_, x), (_, y) in zip(xs, ys))


def test_async_save_under_inplace_lm_step_holds_the_saved_values(tmp_path):
    """The LM step updates params and moments in place.  An async save's
    snapshot is taken before ``save`` returns, so the checkpoint holds the
    state at the save even when the next step runs while the writer does;
    the bf16 params cross as bf16 (C.6)."""
    arch = _lm_bf16()
    init_state, step = make_train_step(arch, ParallelConfig(), TrainConfig(warmup=0, steps=3))
    state, _ = step(init_state(0), _lm_batch(arch, 0))
    expect = map_with_path(lambda p, x: x.clone() if isinstance(x, torch.Tensor) else x, state)
    like = abstract_of(lambda _: state)[0]
    mgr = CheckpointManager(str(tmp_path))
    gate = threading.Event()
    mgr.write_fault = lambda i: gate.wait(60)     # the writer waits for the next step
    mgr.save(0, state, blocking=False)
    state, _ = step(state, _lm_batch(arch, 1))
    gate.set()
    mgr.wait()
    assert not torch.equal(state.params["embed"], expect.params["embed"])
    out = mgr.restore(like, device="cpu")
    assert out.params["embed"].dtype == torch.bfloat16
    assert _same(out, expect)


def test_lm_resume_after_async_save_is_bitwise(tmp_path):
    """4 AdamW steps of the bf16 LM uninterrupted, against 2 steps, an
    async save and a resume for 2 more (the LM launcher's driver)."""
    arch = _lm_bf16()
    init_state, step = make_train_step(arch, ParallelConfig(), TrainConfig(warmup=0, steps=4))
    finals = {}

    def keep(tag):
        def st(state, batch):
            state, m = step(state, batch)
            finals[tag] = state
            return state, m
        return st

    make_batch = lambda s: _lm_batch(arch, s)   # noqa: E731
    run_training(init_state=init_state, train_step=keep("u"), make_batch=make_batch, steps=4,
                 cfg=DriverConfig())
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=2, async_ckpt=True)
    run_training(init_state=init_state, train_step=keep("a"), make_batch=make_batch, steps=2,
                 cfg=cfg)
    rep = run_training(init_state=init_state, train_step=keep("r"), make_batch=make_batch,
                       steps=4, cfg=DriverConfig(ckpt_dir=str(tmp_path), resume="always"))
    assert rep.resumed_step == 1 and rep.steps_done == 2
    assert finals["r"].step == 4 and finals["r"].opt["t"] == 4
    assert _same(finals["r"], finals["u"])


def _tiled_runs():
    arch = make_yolo_tiled_arch(HW, 4, 2, 2, [Group(0, 1), Group(2, 3)], device="cpu")
    init_state, step = make_train_step(arch, ParallelConfig(grad_accum=2),
                                       TrainConfig(lr=1e-3, optimizer="sgd", warmup=0, steps=4))
    from repro_torch.launch.train import make_batch_fn

    make_batch = make_batch_fn(4, HW[0], arch.target_shape(4), 0, "cpu")
    finals = {}

    def run(tag, steps, **kw):
        def st(state, batch):
            state, m = step(state, batch)
            finals[tag] = state
            return state, m
        return run_training(init_state=init_state, train_step=st, make_batch=make_batch,
                            steps=steps, **kw)

    return run, finals, step, make_batch


def test_tiled_resume_and_restart_are_bitwise(tmp_path):
    """Chip phase 18a at 32 px: an uninterrupted run, a run stopped after
    step 1 and resumed with async saves, and a run under ``fail@2`` and a
    one-shot writer crash end in the same bits; a resume whose momentum was
    lost does not."""
    run, finals, step, make_batch = _tiled_runs()
    run("u", 4, cfg=DriverConfig())
    run("r", 2, cfg=DriverConfig(ckpt_dir=str(tmp_path / "r"), ckpt_every=1))
    rep_r = run("r", 4, cfg=DriverConfig(ckpt_dir=str(tmp_path / "r"), ckpt_every=1,
                                         resume="always"))
    rep_f = run("f", 4, cfg=DriverConfig(ckpt_dir=str(tmp_path / "f"), ckpt_every=1,
                                         io_backoff=0.0),
                faults=FaultInjector("fail@2,ckpt-crash@1"))
    assert rep_r.resumed_step == 1 and rep_f.restarts == 1 and rep_f.resumed_step is None
    assert _same(finals["r"], finals["u"]) and _same(finals["f"], finals["u"])
    # planted: the momentum lost at the resume
    st = CheckpointManager(str(tmp_path / "r")).restore(finals["u"], step=1)
    st = st._replace(opt={**st.opt, "m": [{k: torch.zeros_like(v) for k, v in p.items()}
                                           for p in st.opt["m"]]})
    for s in (2, 3):
        st, _ = step(st, make_batch(s))
    assert st.step == 4 and not _same(st, finals["u"])
