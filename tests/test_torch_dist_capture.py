"""The captured step on ranks, as far as the CPU can hold it: which step
``launch/train.py:jit_step`` gives for each device and backend, the plan
line's word on it, the refusals, the record's replay accounting
(``parallel/dist.py:capture_pass``, ``replay_record``), the summed count a captured step
takes from its eager steps (``core/fusion.py:_global_sum``), the replan's
release of the step it replaces, and ``plan_collectives``' forward-only
refusal of a pipeline.  The graphs themselves run on the card only
(``chip_smoke.py`` phase 29(e)).
"""
from collections import Counter

import pytest
import torch

from repro_torch.analysis.collectives import plan_collectives
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import fusion as tfu
from repro_torch.launch.mesh import make_dist_tile_mesh
from repro_torch.launch.train import capture_note, jit_step, make_replan
from repro_torch.models.yolo import make_yolo_tiled_arch, yolov2_16_layers
from repro_torch.parallel.dist import (
    Collective,
    TileGroup,
    capturable,
    capture_pass,
    replay_record,
)
from repro_torch.runtime.faults import ClusterChange
from repro_torch.serve.exec_cache import CapturedStep
from repro_torch.train.trainer import CapturedTrainStep, capture_train_step


def _group(backend, device="cpu", world=2):
    return TileGroup(0, world, backend, torch.device(device))


def _step(state, batch):
    return state, {}


# device, backend (None: one process) -> captured
RULE = [("cpu", None, False), ("cpu", "gloo", False), ("cuda:0", None, True),
        ("cuda:0", "nccl", True), ("cuda:0", "gloo", False)]


@pytest.mark.parametrize("device,backend,captured", RULE)
def test_jit_step_captures_alone_or_under_nccl_on_a_card(device, backend, captured):
    """The reference jits the step everywhere; the port captures it on a
    card, alone or over nccl ranks, and runs it eagerly on the CPU and
    under gloo, whose collectives move through the host."""
    group = None if backend is None else _group(backend, device)
    assert capturable(group, device) is captured
    got = jit_step(_step, device, group)
    if captured:
        assert isinstance(got, CapturedTrainStep) and got.group is group
        assert not got.captured and got.replays == 0
    else:
        assert got is _step


@pytest.mark.parametrize("device,backend,note", [
    ("cpu", "gloo", "captured=False (cpu)"), ("cuda:0", "gloo", "captured=False (gloo)"),
    ("cuda:0", "nccl", "captured=True")])
def test_the_plan_line_says_whether_the_rank_step_is_captured(device, backend, note):
    assert capture_note(device, _group(backend, device)) == note


def test_a_capture_refuses_gloo_and_a_blocking_wait(monkeypatch):
    with pytest.raises(ValueError, match="gloo runs on the host"):
        capture_train_step(_step, "cuda:0", _group("gloo", "cuda:0"))
    with pytest.raises(ValueError, match="gloo runs on the host"):
        CapturedStep(lambda p, x: x, [], (1, 2, 2, 3), dtype=torch.float32,
                     device=torch.device("cuda:0"), counters=dict, group=_group("gloo", "cuda:0"))
    monkeypatch.setenv("TORCH_NCCL_BLOCKING_WAIT", "1")
    with pytest.raises(ValueError, match="TORCH_NCCL_BLOCKING_WAIT"):
        capture_train_step(_step, "cuda:0", _group("nccl", "cuda:0"))


STEP = Counter({Collective("collective-permute", 1536, 2): 4,
                Collective("all-gather", 8192, 2): 1,
                Collective("all-reduce", 16, 2): 3})


@pytest.mark.parametrize("steps", [3, 6])
def test_a_captured_runs_record_is_the_eager_runs(steps):
    """Eager: every step records its collectives.  Captured: the warm steps
    record theirs, the capture's pass is taken back out of the record
    (``capture_pass``), and each replay adds it (``replay_record``), so the
    two records are equal."""
    eager, captured = _group("nccl", "cuda:0"), _group("nccl", "cuda:0")
    for _ in range(steps):
        eager.record.update(STEP)
    for _ in range(2):                       # WARM_RUNS eager steps
        captured.record.update(STEP)
    with capture_pass(captured) as graph:
        captured.record.update(STEP)         # the capture's one pass
    assert graph == STEP and captured.record == replay_record(Counter(), STEP, 2)
    for _ in range(steps - 2):
        replay_record(captured.record, graph)
    assert captured.record == eager.record
    with capture_pass(None) as nothing:
        pass
    assert nothing == Counter()


def test_replay_record_adds_each_collective_times_the_replays():
    record = Counter({Collective("all-reduce", 4, 2, "agree"): 1})
    out = replay_record(record, STEP, 5)
    assert out is record
    assert record == Counter({Collective("all-reduce", 4, 2, "agree"): 1,
                              **{c: 5 * t for c, t in STEP.items()}})
    assert replay_record(Counter(STEP), Counter(), 7) == STEP


def test_an_eager_rank_step_keeps_the_summed_count_for_its_capture(tmp_path):
    """``_global_sum`` reads the ranks' summed count back on an eager step
    and keeps it for the caller; a step being captured (no read-back)
    takes the kept one."""
    import torch.distributed as dist

    from repro_torch.parallel import dist as tdist

    kept: dict = {}
    group = tdist._init(0, 1, 0, 1, "cpu", "gloo", f"file://{tmp_path / 'store'}", 60)
    try:
        mesh = make_dist_tile_mesh(2, 2, "cpu", group)
        s, c = tfu._global_sum(mesh, torch.tensor(3.5), 6.0, kept)
        assert float(s) == 3.5 and c == 6.0 and kept == {6.0: 6.0}
        assert group.take_record() == Counter({Collective("all-reduce", 16, 1): 1})
    finally:
        dist.destroy_process_group()


class _Graph:
    def __init__(self):
        self.released = False

    def release(self):
        self.released = True


def test_a_replan_releases_the_step_it_replaces():
    """The old step's graph goes at the replan (the reference's old
    executable with its last reference), the replan's own step at the
    next one."""
    arch = make_yolo_tiled_arch(input_hw=(32, 32), depth=4, n=2, m=2, groups=None,
                                device="cpu")
    first = _Graph()
    replan = make_replan(arch, None, "pi3-core", 8, ParallelConfig(), TrainConfig(), None, first)
    step, _ = replan(ClusterChange("drop", "3", 1))
    assert first.released and replan.live["step"] is step and replan.live["steps"] == [step]
    second = _Graph()
    replan.live["step"] = second
    replan(ClusterChange("add", "pi3-core", 2))
    assert second.released


def test_a_pipeline_plan_has_no_serve_dispatch_to_model():
    plan = tfu.build_stack_plan((64, 64), yolov2_16_layers(batch_norm=False)[:8], 2, 2, "auto",
                                pipeline=2, hw="jetson-nano-gpu", batch=8, microbatches=2)
    with pytest.raises(ValueError, match="no single-shot forward"):
        plan_collectives(plan, 8, (2, 1), forward_only=True)
