"""Elastic training on ``torch.distributed`` ranks (``runtime/driver.py``'s
loop on ranks, ``launch/train.py:make_replan`` with a group) against the
port's virtual-mesh elastic runs, which ``tests/test_torch_elastic.py``
holds against the JAX reference.

The slice is ``scripts/check_elastic.py``'s headline: YOLOv2's first 4
layers at 64x64, the ``pi3x3+jetson`` cluster on a 2x2 grid (or the
homogeneous 2x2 grid of ``pi3-core``), batch 4, SGD under the headline's
schedule, in fp64 where a bar is ``FP64_BAR``.  CPU ranks run gloo, one
intra-op thread each, one spawn of ranks per scenario, each with a timeout
of its own; the virtual-mesh twin runs in this process meanwhile.

- W = 1: the launcher's path under ``drop:jetson@2,fail@3,ckpt-crash@1,
  corrupt@4``: every step's params and every checkpoint's files bitwise
  the virtual run's;
- W = 4, one tile a rank: the Jetson drops at step 4 of 8, ranks 0-2 go on
  at 1x3 while rank 3 idles, then the survivors' checkpoint resumes on the
  2x2 plan on 4 ranks to step 10: every step within ``FP64_BAR`` of the
  virtual run, the final params within the headline's 1e-5 of the untiled
  run, only rank 0 made a checkpoint manager, every active rank's state
  bitwise equal after every step, and the driver's collectives its model;
  the final checkpoint resumes on the virtual mesh bit for bit;
- W = 2: 2x2 -> ``drop:1`` -> 1x3 (rank 1 idles: ``rank_grid(1, 3, 2)`` has
  no split) -> ``add:pi3-core`` -> 2x2 with rank 1 back; a planted return
  that skips the live state's broadcast fails the bar; ``resume="always"``
  with an empty directory raises on every rank; a checkpoint the virtual
  mesh wrote resumes on the ranks bit for bit;
- W = 2, a failure on rank 1 alone (its ``fault_hook``): every rank
  restarts from rank 0's checkpoint; a planted restore that the other
  ranks skip fails the bar;
- the launcher under torchrun with 2 gloo ranks: chip phase 18's
  drop-then-resume commands give the plain launcher's replan line, counts
  and loss.
"""
import concurrent.futures
import copy
import filecmp
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.analysis.collectives import driver_collectives, split_record
from repro_torch.ckpt.manager import CheckpointManager, map_with_path
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core.fusion import plan_manifest
from repro_torch.core.grouping import parse_cluster_spec
from repro_torch.launch.mesh import make_dist_tile_mesh
from repro_torch.launch.train import make_batch_fn, make_replan
from repro_torch.models.yolo import make_yolo_tiled_arch
from repro_torch.parallel.dist import run_ranks
from repro_torch.runtime import driver as tdriver
from repro_torch.runtime.driver import DriverConfig, run_training
from repro_torch.runtime.faults import FaultError, FaultInjector
from repro_torch.train.trainer import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, DEPTH, BATCH, SEED = 64, 4, 4, 0
TCFG = dict(lr=1e-2, optimizer="sgd", warmup=10, steps=100, grad_clip=1.0)  # the headline's
FP64_BAR = 1e-12                 # ranks vs the virtual mesh, fp64, x max(1, |ref|)
PARAM_ATOL = 1e-5                # scripts/check_elastic.py:182
W1_FAULTS = "drop:jetson@2,fail@3,ckpt-crash@1,corrupt@4"
SPAWN_TIMEOUT = 120              # each scenario's ranks, a few times their time


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _np_state(state) -> dict:
    out = {}
    map_with_path(lambda p, x: out.__setitem__(
        p, x.detach().numpy().copy() if isinstance(x, torch.Tensor) else x), state)
    return out


def _to64(state):
    return map_with_path(lambda _, x: x.double() if isinstance(x, torch.Tensor)
                         and x.is_floating_point() else x, state)


def _train(group, ckpt_dir, *, cluster=True, faults=None, steps, ckpt_every=1,
           resume="auto", hook_rank=None, plant=None):
    """One elastic run of the slice on ``group``'s ranks (None: the virtual
    mesh), fp64, the launcher's ``make_replan``: -> each step's state after
    it (``hist``: (step, leaves)), the state the first step took, the
    report's counts, the checkpoint managers this rank made and its
    record.  ``hook_rank``: a ``fault_hook`` raises once at step 3 on that
    rank alone.  ``plant``: the other ranks skip rank 0's ``restore`` or a
    returning rank skips the live state's ``return`` broadcast (each still
    takes part in it, so the collectives pair)."""
    torch.set_num_threads(1)
    pcfg, tcfg = ParallelConfig(grad_accum=1), TrainConfig(**TCFG)
    cl = parse_cluster_spec("pi3x3+jetson", 2, 2) if cluster else None
    mesh = None if group is None else make_dist_tile_mesh(2, 2, "cpu", group)
    arch = make_yolo_tiled_arch((HW, HW), DEPTH, 2, 2, backend="torch", hw=cl, device="cpu",
                                mesh=mesh)
    init32, step0 = make_train_step(arch, pcfg, tcfg)
    make32 = make_batch_fn(BATCH, HW, arch.target_shape(BATCH), SEED, "cpu")
    replan = make_replan(arch, cl, "pi3-core", BATCH, pcfg, tcfg, group)
    out = {"hist": [], "first": None, "managers": 0}

    def keep(fn):
        def step(state, batch):
            if out["first"] is None:
                out["first"] = _np_state(state)
            state, m = fn(state, batch)
            out["hist"].append((int(state.step), _np_state(state.params)))
            return state, m
        return step

    def replan_kept(ev):
        fn, man = replan(ev)
        return (None if fn is None else keep(fn)), man

    fired = []

    def hook(s):
        if s == 3 and not fired:
            fired.append(s)
            raise FaultError(f"rank {group.rank} failed before step 3")

    real_mgr, real_share = tdriver.CheckpointManager, tdriver._share_state

    class Counted(real_mgr):
        def __init__(self, *a, **k):
            out["managers"] += 1
            super().__init__(*a, **k)

    def planted(g, state, role):
        if role != plant or g.rank == 0:
            return real_share(g, state, role)
        real_share(g, copy.deepcopy(state), role)
        return state

    tdriver.CheckpointManager, tdriver._share_state = Counted, planted
    if group is not None:
        group.take_record()
    try:
        rep = run_training(
            init_state=lambda seed: _to64(init32(seed)), train_step=keep(step0),
            make_batch=lambda s: {k: v.double() for k, v in make32(s).items()},
            steps=steps, seed=SEED, device="cpu", plan=plan_manifest(arch.plan, cl),
            faults=FaultInjector(faults) if faults else None, replan=replan_kept,
            fault_hook=hook if group is not None and group.rank == hook_rank else None,
            cfg=DriverConfig(ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, async_ckpt=True,
                             resume=resume),
            group=group)
    finally:
        tdriver.CheckpointManager, tdriver._share_state = real_mgr, real_share
    out["report"] = dict(steps_done=rep.steps_done, restarts=rep.restarts, replans=rep.replans,
                         resumed_step=rep.resumed_step, attempts=len(rep.step_times))
    out["record"] = None if group is None else group.take_record()
    return out


def _rank_jobs(group, jobs):
    """Every run of ``jobs`` ((kwargs, expect) in turn) on these ranks:
    expect "raises" catches the run's FileNotFoundError."""
    outs = []
    for kw, expect in jobs:
        if expect == "raises":
            try:
                _train(group, **kw)
                outs.append(False)
            except FileNotFoundError:
                outs.append(True)
        else:
            outs.append(_train(group, **kw))
    return outs


def _beside(world, jobs, virtual_jobs):
    """``jobs`` on ``world`` spawned ranks while this process runs the
    virtual twins (``_train(None, **kw)`` of ``virtual_jobs``)."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_ranks, _rank_jobs, world, "cpu", args=(jobs,),
                        timeout=SPAWN_TIMEOUT)
        virtual = [_train(None, **kw) for kw in virtual_jobs]
        return fut.result(), virtual


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def _worst(hist, want_hist) -> float:
    """The largest relative error of a run's states against the virtual
    run's at the same steps (a replayed step against its last run)."""
    want = dict(want_hist)
    assert {s for s, _ in hist} <= set(want)
    return max(_rel(leaf, want[s][p]) for s, got in hist for p, leaf in got.items())


def _same(a: dict, b: dict) -> bool:
    return list(a) == list(b) and all(np.array_equal(a[k], b[k]) for k in a)


def _ckpt_files_equal(a: str, b: str) -> bool:
    steps = sorted(os.listdir(a))
    if steps != sorted(os.listdir(b)):
        return False
    for s in steps:
        files = sorted(os.listdir(os.path.join(a, s)))
        _, mismatch, errors = filecmp.cmpfiles(os.path.join(a, s), os.path.join(b, s), files,
                                               shallow=False)
        if mismatch or errors or files != sorted(os.listdir(os.path.join(b, s))):
            return False
    return True


# ---------------------------------------------------------------------------
# W = 1: bitwise the virtual mesh
# ---------------------------------------------------------------------------


def test_one_rank_is_bitwise_the_virtual_run(tmp_path):
    """The whole grid on one rank under ``W1_FAULTS``: a drop (1x3 stays on
    rank 0), a failed step restored from rank 0's checkpoint, a writer
    crash absorbed, a corrupted leaf.  Every step's params and every
    checkpoint file equal the virtual run's bit for bit."""
    kw = dict(faults=W1_FAULTS, steps=6, ckpt_every=1)
    (ranks,), (virtual,) = _beside(1, [(dict(kw, ckpt_dir=str(tmp_path / "ranks")), None)],
                                   [dict(kw, ckpt_dir=str(tmp_path / "virtual"))])
    (out,) = ranks
    assert out["report"] == virtual["report"]
    assert out["report"]["replans"] == 1 and out["report"]["restarts"] == 1
    assert [s for s, _ in out["hist"]] == [s for s, _ in virtual["hist"]] == [1, 2, 3, 4, 5, 6]
    assert all(_same(a, b) for (_, a), (_, b) in zip(out["hist"], virtual["hist"]))
    assert _ckpt_files_equal(str(tmp_path / "ranks"), str(tmp_path / "virtual"))


# ---------------------------------------------------------------------------
# W = 4, one tile a rank: the headline on ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def headline(tmp_path_factory):
    d = tmp_path_factory.mktemp("headline")
    drop = dict(faults="drop:jetson@4", steps=8, ckpt_every=3)
    back = dict(steps=10, ckpt_every=3, resume="always")
    ranks, virtual = _beside(
        4, [(dict(drop, ckpt_dir=str(d / "ranks")), None),
            (dict(back, ckpt_dir=str(d / "ranks")), None)],
        [dict(drop, ckpt_dir=str(d / "virtual")), dict(back, ckpt_dir=str(d / "virtual"))])
    return ranks, virtual, d


def test_headline_on_four_ranks_matches_the_virtual_run(headline):
    """Ranks 0-2 run the survivors' 1x3 plan after the Jetson drops and
    rank 3 idles; the 2x2 plan resumes the survivors' checkpoint on all 4
    ranks.  Every step within ``FP64_BAR`` of the virtual run."""
    ranks, (vdrop, vback), _ = headline
    for r, (drop, back) in enumerate(ranks):
        assert drop["report"]["replans"] == 1 and drop["report"]["restarts"] == 0
        want = [1, 2, 3, 4] + ([5, 6, 7, 8] if r < 3 else [])
        assert [s for s, _ in drop["hist"]] == want, r
        assert back["report"]["resumed_step"] == 7 and [s for s, _ in back["hist"]] == [9, 10]
        assert _worst(drop["hist"], vdrop["hist"]) <= FP64_BAR
        assert _worst(back["hist"], vback["hist"]) <= FP64_BAR


def test_headline_on_four_ranks_meets_the_untiled_run(headline):
    """The final params within the headline's 1e-5 of the uninterrupted
    untiled run (fp64 here)."""
    ranks, _, _ = headline
    ref_arch = make_yolo_tiled_arch((HW, HW), DEPTH, 1, 1, backend="torch", device="cpu")
    pcfg, tcfg = ParallelConfig(grad_accum=1), TrainConfig(**TCFG)
    init, step = make_train_step(ref_arch, pcfg, tcfg)
    make = make_batch_fn(BATCH, HW, ref_arch.target_shape(BATCH), SEED, "cpu")
    ref = _to64(init(SEED))
    for s in range(10):
        ref, _ = step(ref, {k: v.double() for k, v in make(s).items()})
    want = _np_state(ref.params)
    final = ranks[0][1]["hist"][-1][1]
    assert max(float(np.max(np.abs(final[p] - want[p]))) for p in want) <= PARAM_ATOL


def test_only_rank_zero_writes_and_every_active_rank_holds_one_state(headline):
    """Rank 0 alone made a checkpoint manager (the others never touch the
    directory), and after every step each active rank's state is bit for
    bit rank 0's."""
    ranks, _, d = headline
    assert [[run["managers"] for run in r] for r in ranks] == [[1, 1], [0, 0], [0, 0], [0, 0]]
    assert all(n.startswith("step_") and not n.endswith(".tmp") for n in os.listdir(d / "ranks"))
    for r in ranks[1:]:
        for run, run0 in zip(r, ranks[0]):
            steps0 = dict(run0["hist"])
            assert all(_same(state, steps0[s]) for s, state in run["hist"])


def test_driver_collectives_equal_their_model(headline):
    """Beside its steps, a rank records one 4-byte agreement a step it
    attempted, the world's meetings (the replan, the end), rank 0's
    decisions and the params' init broadcast (``driver_collectives``)."""
    ranks, _, _ = headline
    for r, (drop, back) in enumerate(ranks):
        leaves = [4 * v.size for v in drop["hist"][0][1].values()]    # init's fp32 params
        agreed = drop["report"]["attempts"] + 1            # the step the drop was agreed at
        want = driver_collectives(agreements=agreed, meetings=2, decisions=1,
                                  shares={"init": (1, leaves)})
        assert split_record(drop["record"])[1] == want, r
        # the resume: rank 0's decision and the step it loaded, the state
        state_leaves = [v.nbytes if isinstance(v, np.ndarray) else 0
                        for v in back["first"].values()]
        want = driver_collectives(agreements=back["report"]["attempts"], meetings=1, decisions=2,
                                  shares={"init": (1, leaves), "restore": (1, state_leaves)})
        assert split_record(back["record"])[1] == want, r


def test_four_rank_checkpoint_resumes_on_the_virtual_mesh(headline, tmp_path):
    """The 2x2 plan's last checkpoint, written by rank 0 of 4, resumes on
    the virtual mesh: the state it restores is the ranks' final state bit
    for bit, and it trains on."""
    ranks, _, d = headline
    shutil.copytree(d / "ranks", tmp_path / "ckpt")
    out = _train(None, str(tmp_path / "ckpt"), steps=11, resume="always")
    assert out["report"]["resumed_step"] == 9
    final = ranks[0][1]["hist"][-1][1]
    assert _same({p[len("params/"):]: v for p, v in out["first"].items()
                  if p.startswith("params/")}, final)
    assert [s for s, _ in out["hist"]] == [11]


# ---------------------------------------------------------------------------
# W = 2: drop, then add, the idle rank back; the resume decisions
# ---------------------------------------------------------------------------


ADD = dict(cluster=False, faults="drop:1@2,add:pi3-core@4", steps=6, ckpt_every=2)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("two")
    # the virtual mesh's checkpoint the ranks resume
    _train(None, str(d / "from_virtual"), cluster=False, steps=2, ckpt_every=1)
    jobs = [(dict(ADD, ckpt_dir=str(d / "add")), None),
            (dict(ADD, ckpt_dir=str(d / "planted"), plant="return"), None),
            (dict(ckpt_dir=str(d / "empty"), cluster=False, steps=2, resume="always"), "raises"),
            (dict(ckpt_dir=str(d / "from_virtual"), cluster=False, steps=4, resume="always"),
             None)]
    ranks, virtual = _beside(2, jobs, [dict(ADD, ckpt_dir=str(d / "virtual")),
                                       dict(cluster=False, ckpt_dir=str(d / "virtual4"),
                                            steps=4, ckpt_every=1)])
    return ranks, virtual


def test_drop_then_add_brings_the_idle_rank_back(two_ranks):
    """2x2 -> ``drop:1`` -> 1x3 on rank 0 alone (rank 1 idles) ->
    ``add:pi3-core`` -> 2x2 on both, rank 1 back with the live state:
    within ``FP64_BAR`` of the virtual run, both ranks equal."""
    ranks, (vadd, _) = two_ranks
    (r0, *_), (r1, *_) = ranks
    assert [s for s, _ in r0["hist"]] == [1, 2, 3, 4, 5, 6]
    assert [s for s, _ in r1["hist"]] == [1, 2, 5, 6]
    assert r0["report"]["replans"] == r1["report"]["replans"] == 2
    for r in (r0, r1):
        assert _worst(r["hist"], vadd["hist"]) <= FP64_BAR
    steps0 = dict(r0["hist"])
    assert all(_same(state, steps0[s]) for s, state in r1["hist"])


def test_a_return_without_the_live_state_fails_the_bar(two_ranks):
    """Planted: rank 1 comes back at the add but keeps the state it went
    idle with; the run then leaves the virtual trajectory far past the
    bar."""
    ranks, (vadd, _) = two_ranks
    planted = ranks[0][1]
    assert _worst(planted["hist"], vadd["hist"]) > 1e6 * FP64_BAR


def test_resume_always_without_a_checkpoint_raises_on_every_rank(two_ranks):
    ranks, _ = two_ranks
    assert [r[2] for r in ranks] == [True, True]


def test_virtual_checkpoint_resumes_on_two_ranks(two_ranks):
    """A checkpoint the virtual mesh wrote resumes on 2 ranks: each rank
    starts from the virtual state after step 1 bit for bit, and steps 2-3
    stay within ``FP64_BAR`` of the virtual run."""
    ranks, (_, v4) = two_ranks
    want = dict(v4["hist"])
    for r in ranks:
        out = r[3]
        assert out["report"]["resumed_step"] == 1
        assert _same({p[len("params/"):]: v for p, v in out["first"].items()
                      if p.startswith("params/")}, want[2])
        assert [s for s, _ in out["hist"]] == [3, 4]
        assert _worst(out["hist"], v4["hist"]) <= FP64_BAR


# ---------------------------------------------------------------------------
# W = 2: a failure on one rank only; a restore the other ranks skip
# ---------------------------------------------------------------------------


FAIL = dict(cluster=False, steps=5, ckpt_every=2)


@pytest.fixture(scope="module")
def one_rank_fails(tmp_path_factory):
    d = tmp_path_factory.mktemp("fail")
    jobs = [(dict(FAIL, ckpt_dir=str(d / "ranks"), hook_rank=1), None),
            (dict(FAIL, ckpt_dir=str(d / "planted"), hook_rank=1, plant="restore"), None)]
    return _beside(2, jobs, [dict(FAIL, ckpt_dir=str(d / "virtual"), faults="fail@3")])


def test_a_failure_on_one_rank_restarts_every_rank(one_rank_fails):
    """Rank 1's ``fault_hook`` raises before step 3: both ranks agree on
    the failure, restore rank 0's step-1 checkpoint (the live state had
    run step 2), report one restart and end on the virtual run under
    ``fail@3``."""
    ranks, (virtual,) = one_rank_fails
    for r in ranks:
        out = r[0]
        assert out["report"]["restarts"] == 1 == virtual["report"]["restarts"]
        assert [s for s, _ in out["hist"]] == [s for s, _ in virtual["hist"]] == [1, 2, 3, 3, 4,
                                                                                   5]
        assert _worst(out["hist"], virtual["hist"]) <= FP64_BAR
    assert _same(ranks[0][0]["hist"][-1][1], ranks[1][0]["hist"][-1][1])


def test_a_restore_the_other_ranks_skip_fails_the_bar(one_rank_fails):
    """Planted: rank 1 takes part in rank 0's broadcast but keeps its
    pre-failure state (after step 2, where the checkpoint holds step 1's):
    the replayed steps leave the virtual run far past the bar."""
    ranks, (virtual,) = one_rank_fails
    assert _worst(ranks[0][1]["hist"], virtual["hist"]) > 1e6 * FP64_BAR


# ---------------------------------------------------------------------------
# the launcher under torchrun
# ---------------------------------------------------------------------------


def test_launcher_drop_then_resume_on_two_ranks(tmp_path, capsys):
    """``tests/test_torch_elastic.py``'s launcher commands (chip phase 18's
    at 64 px) with ``--dist`` under torchrun on 2 gloo ranks: the plain
    launcher's replan line, then ``dist=1 idle=[1]`` (two ranks do not
    split a 1x3 grid), its ``done:`` counts and its loss; the resumed run
    goes on to step 6 on both ranks."""
    from repro_torch.launch.train import main

    def base(d):
        return ["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "64", "--depth", "8",
                "--grid", "2", "--cluster", "pi3x3+jetson", "--groups", "auto", "--batch", "4",
                "--grad-accum", "2", "--ckpt-dir", str(d), "--ckpt-every", "1"]

    first = ["--steps", "4", "--fault-schedule", "drop:jetson@1,slow:0.2@2,ckpt-crash@2,corrupt@3"]
    second = ["--steps", "6", "--resume", "always"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))

    def torchrun(argv):
        return subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                               "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv,
                               "--dist", "--dist-backend", "gloo"],
                              env=env, capture_output=True, text=True, timeout=300)

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(torchrun, base(tmp_path / "ranks") + first)
        assert main(base(tmp_path / "plain") + first) == 0
        plain = capsys.readouterr().out
        run = fut.result()
        assert run.returncode == 0, run.stdout + run.stderr
        fut = ex.submit(torchrun, base(tmp_path / "ranks") + second)
        assert main(base(tmp_path / "plain") + second) == 0
        plain2 = capsys.readouterr().out
        run2 = fut.result()
        assert run2.returncode == 0, run2.stdout + run2.stderr

    def line(text, head):
        (got,) = [ln for ln in text.splitlines() if ln.startswith(head)]
        return got

    replan = line(plain, "replan (drop:jetson): grid=1x3")
    assert line(run.stdout, "replan (") == replan + " dist=1 idle=[1]"
    assert line(run.stdout, "done:") == line(plain, "done:")
    assert "done: steps=4 restarts=0 replans=1" in run.stdout
    assert line(run2.stdout, "done:") == line(plain2, "done:")
    assert "done: steps=2 restarts=0 replans=0" in run2.stdout
    assert CheckpointManager(str(tmp_path / "ranks")).latest_step() == 5
