"""Elastic training in the port (DESIGN.md §10) against the JAX reference.

- every case of ``tests/test_elastic.py`` on the port: the fault grammar,
  the injector, cluster surgery (drop/add and the grid re-pack), plan and
  cluster manifests, ``replan_stack`` and its degradation, the driver's
  ClusterChange -> replan path and the trainer's state helpers;
- ``runtime.faults`` parses every schedule as the reference does, with the
  same messages;
- ``replan_stack`` and ``plan_manifest`` equal the reference's, key for key
  apart from the backend's name, for a device drop, an add, the
  degradation ladder and a pipeline tail; ``plan_from_manifest`` reads a
  manifest the reference wrote (``pallas`` -> ``cuda``, ``xla`` ->
  ``torch``);
- the strong parity test: the reference's ``run_training`` writes a step-2
  checkpoint of a 2x2 plan (a subprocess with 4 fake devices) and goes on
  to step 4; the port resumes the same checkpoint to step 4 and its params
  lie within 1e-5 of JAX's (the bar of ``scripts/check_elastic.py``);
- ``scripts/check_elastic.py``'s scenario (a) on the port: ``pi3x3+jetson``
  on 2x2, the Jetson lost at step 4, the survivors' 1x3 plan, its
  checkpoint resumed on the 2x2 cluster; the final params within 1e-5 of
  the uninterrupted untiled run;
- the launcher's elastic flags at a small size;
- the same JAX-written checkpoint resumed on 2 gloo ranks
  (``parallel/dist.py:run_ranks``; rank 0 restores and broadcasts), its
  params within 1e-5 of JAX's (``tests/test_torch_dist_elastic.py`` holds
  the ranks' other elastic paths against the virtual mesh).
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import build_stack_plan as jbuild
from repro.core import drop_device as jdrop
from repro.core import add_device as jadd
from repro.core import parse_cluster_spec as jparse
from repro.core import plan_manifest as jmanifest
from repro.core import replan_stack as jreplan
from repro.core.spatial import LayerDef as JLayerDef
from repro.models.yolo import yolov2_16_layers as jax_yolo_layers
from repro.runtime import faults as jfaults
from repro_torch.ckpt.manager import CheckpointManager, map_with_path
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import (
    JETSON_PROFILE,
    PI3_PROFILE,
    add_device,
    build_stack_plan,
    cluster_from_manifest,
    cluster_manifest,
    drop_device,
    pack_devices,
    parse_cluster_spec,
    plan_from_manifest,
    plan_manifest,
    replan_stack,
)
from repro_torch.core.spatial import LayerDef, init_stack_params
from repro_torch.models.yolo import make_yolo_tiled_arch
from repro_torch.runtime.driver import DriverConfig, run_training
from repro_torch.runtime.faults import (
    ClusterChange,
    Fault,
    FaultError,
    FaultInjector,
    parse_fault_schedule,
)
from repro_torch.train.trainer import (
    TrainState,
    abstract_of,
    check_state_matches,
    globalize_state,
    make_train_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAM_ATOL = 1e-5          # scripts/check_elastic.py:182

LAYERS = (
    LayerDef(kernel=3, stride=1, in_channels=3, out_channels=8),
    LayerDef(kernel=3, stride=1, in_channels=8, out_channels=8, pool=2),
)
JLAYERS = tuple(JLayerDef(**dataclasses.asdict(l)) for l in LAYERS)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the reference's checkpoint and continued run, started with the module's
# first test so that it runs beside the rest
# ---------------------------------------------------------------------------

SEED, HW, BATCH = 0, 32, 4
PARITY_TCFG = dict(lr=1e-2, optimizer="sgd", warmup=0, steps=5)

_JAX_RESUME = textwrap.dedent("""
    import shutil, sys
    import jax, numpy as np
    from repro.ckpt.manager import CheckpointManager
    from repro.compat import keystr_slash
    from repro.configs.base import ParallelConfig, TrainConfig
    from repro.core import build_stack_plan, plan_manifest
    from repro.launch.mesh import make_tile_mesh
    from repro.models.tiled_cnn import TiledCNNArch
    from repro.models.yolo import l2_loss_local, yolov2_16_layers
    from repro.runtime.driver import DriverConfig, run_training
    from repro.train.trainer import make_train_step

    d = sys.argv[1]
    plan = build_stack_plan((%(hw)d, %(hw)d), yolov2_16_layers()[:4], 2, 2, backend="xla")
    arch = TiledCNNArch(plan=plan, mesh=make_tile_mesh(2, 2), loss_local=l2_loss_local)
    init_state, step = make_train_step(arch, ParallelConfig(grad_accum=2), TrainConfig(**%(tcfg)r))
    step = jax.jit(step)
    tgt = arch.target_shape(%(batch)d)

    def make_batch(s):
        rng = np.random.default_rng([%(seed)d, s])
        x = rng.standard_normal((%(batch)d, %(hw)d, %(hw)d, 3), np.float32)
        return {"x": x, "t": 0.05 * rng.standard_normal(tgt, np.float32)}

    kw = dict(init_state=init_state, train_step=step, make_batch=make_batch, seed=%(seed)d,
              plan=plan_manifest(plan))
    run_training(steps=3, cfg=DriverConfig(ckpt_dir=d + "/ckpt", ckpt_every=1, async_ckpt=False),
                 **kw)
    shutil.copytree(d + "/ckpt", d + "/cont")
    run_training(steps=5, cfg=DriverConfig(ckpt_dir=d + "/cont", ckpt_every=1,
                                           async_ckpt=False, resume="always"), **kw)
    final = CheckpointManager(d + "/cont").restore(jax.eval_shape(init_state,
                                                                  jax.random.PRNGKey(0)))
    np.savez(d + "/final.npz", **{keystr_slash(p): np.asarray(x)
                                  for p, x in jax.tree_util.tree_leaves_with_path(final)})
""") % dict(hw=HW, batch=BATCH, seed=SEED, tcfg=PARITY_TCFG)


@pytest.fixture(scope="module", autouse=True)
def jax_resumed(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_elastic")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_RESUME, str(d)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, d
    if proc.poll() is None:
        proc.kill()
        proc.wait()


# ---------------------------------------------------------------------------
# fault schedule parsing
# ---------------------------------------------------------------------------

FULL = ("drop:jetson@5, slow:0.2@8, ckpt-crash@10, corrupt@12, fail@3, ckpt-crash:9@14, "
        "add:pi3@20")


def test_parse_fault_schedule_full_grammar():
    faults = parse_fault_schedule(FULL)
    assert [f.kind for f in faults] == [
        "fail", "drop", "slow", "ckpt-crash", "corrupt", "ckpt-crash", "add"]
    by_kind = {(f.kind, f.step): f for f in faults}
    assert by_kind[("drop", 5)].arg == "jetson"
    assert by_kind[("slow", 8)].arg == 0.2
    assert by_kind[("ckpt-crash", 10)].arg == 1
    assert by_kind[("ckpt-crash", 14)].arg == 9
    assert by_kind[("add", 20)].arg == "pi3"


BAD = ["drop:jetson", "drop@5", "warp:x@5", "slow:-1@5", "drop:jetson@x"]


@pytest.mark.parametrize("bad", BAD)
def test_parse_fault_schedule_rejects(bad):
    with pytest.raises(ValueError):
        parse_fault_schedule(bad)


@pytest.mark.parametrize("spec", [FULL, "drop:1@2", "fail@0,slow:0@1"] + BAD)
def test_parse_fault_schedule_equals_the_references(spec):
    """The port's copy of the grammar gives the reference's faults, or the
    reference's error message."""
    def parse(mod):
        try:
            return [(f.kind, f.step, f.arg) for f in mod.parse_fault_schedule(spec)]
        except ValueError as e:
            return str(e)

    assert parse(sys.modules[parse_fault_schedule.__module__]) == parse(jfaults)


def test_fault_injector_fires_each_fault_once():
    inj = FaultInjector("slow:0.5@2,drop:jetson@4", sleep=lambda s: None)
    inj.on_step(0)
    inj.on_step(1)
    assert len(inj.fired) == 0
    inj.on_step(2)
    assert [f.kind for f in inj.fired] == ["slow"]
    inj.on_step(3)
    with pytest.raises(ClusterChange) as ei:
        inj.on_step(4)
    assert ei.value.kind == "drop" and ei.value.device == "jetson"
    inj.on_step(4)
    assert len(inj.pending) == 0


def test_fault_injector_fires_skipped_steps():
    inj = FaultInjector([Fault("fail", 3)])
    with pytest.raises(FaultError):
        inj.on_step(7)


# ---------------------------------------------------------------------------
# cluster surgery: drop / add / re-pack
# ---------------------------------------------------------------------------


def test_drop_jetson_repacks_to_1x3():
    surv = drop_device(parse_cluster_spec("pi3x3+jetson", 2, 2), "jetson")
    assert (surv.n, surv.m) == (1, 3)
    assert all(p == PI3_PROFILE for p in surv.devices)


def test_drop_by_flat_index():
    c = parse_cluster_spec("pi3x3+jetson", 2, 2)
    assert all(p == PI3_PROFILE for p in drop_device(c, 3).devices)
    with pytest.raises(ValueError, match="out of range"):
        drop_device(c, 4)


def test_drop_unknown_device_raises():
    with pytest.raises(ValueError, match="no device 'jetson'"):
        drop_device(parse_cluster_spec("pi3x4", 2, 2), "jetson")


def test_drop_last_device_raises():
    with pytest.raises(ValueError, match="last device"):
        drop_device(parse_cluster_spec("pi3", 1, 1), "pi3")


def test_add_device_repacks_square():
    c = parse_cluster_spec("pi3x3", 1, 3)
    grown = add_device(c, "jetson")
    assert (grown.n, grown.m) == (2, 2)
    assert sum(p == JETSON_PROFILE for p in grown.devices) == 1
    with pytest.raises(ValueError, match="unknown device"):
        add_device(c, "warp-core")


def test_pack_devices_grids():
    assert (pack_devices("c", [PI3_PROFILE] * 6).n, pack_devices("c", [PI3_PROFILE] * 6).m) == (2, 3)
    assert (pack_devices("c", [PI3_PROFILE] * 7).n, pack_devices("c", [PI3_PROFILE] * 7).m) == (1, 7)
    with pytest.raises(ValueError):
        pack_devices("c", [])


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------


def test_cluster_manifest_roundtrip():
    c = parse_cluster_spec("pi3x3+jetson", 2, 2)
    c2 = cluster_from_manifest(json.loads(json.dumps(cluster_manifest(c))))
    assert c2.name == c.name and c2.grid == c.grid


def _plans_and_clusters():
    cluster = parse_cluster_spec("pi3x3+jetson", 2, 2)
    return [
        (build_stack_plan((64, 64), LAYERS, 2, 2), None),
        (build_stack_plan((64, 64), LAYERS, 2, 2, hw=cluster), cluster),
        (build_stack_plan((64, 64), LAYERS, 2, 2, crossover=1), None),
        (build_stack_plan((64, 64), LAYERS, 2, 2, "auto", pipeline=2), None),
    ]


def test_plan_manifest_roundtrip_uniform_hetero_hybrid():
    for plan, cl in _plans_and_clusters():
        man = json.loads(json.dumps(plan_manifest(plan, cl)))
        assert plan_from_manifest(man) == plan
        if cl is not None:
            assert cluster_from_manifest(man["cluster"]).grid == cl.grid
        else:
            assert man["cluster"] is None
        assert plan_from_manifest(man).stages == plan.stages


@pytest.mark.parametrize("backend,want", [("xla", "torch"), ("pallas", "cuda")])
def test_plan_from_manifest_reads_the_references_backends(backend, want):
    """A manifest the reference wrote names its backend "xla" or "pallas";
    the port plans the same function on "torch" or "cuda"."""
    jplan = jbuild((64, 64), JLAYERS, 2, 2, backend=backend)
    man = json.loads(json.dumps(jmanifest(jplan)))
    plan = plan_from_manifest(man)
    assert plan.backend == want
    assert plan == build_stack_plan((64, 64), LAYERS, 2, 2, backend=want)


def test_checkpoint_under_pipeline_plan_restores_under_spatial(tmp_path):
    """Checkpoints are partition-independent: a state saved while training
    a pipeline plan restores bit for bit for a spatial plan over the same
    layers, and the manifest still names the staged plan."""
    pipe_plan = build_stack_plan((64, 64), LAYERS, 2, 2, "auto", pipeline=2)
    assert pipe_plan.stages
    spatial_plan = build_stack_plan((64, 64), LAYERS, 2, 2)
    assert spatial_plan.layers == pipe_plan.layers
    state = {"params": init_stack_params(torch.Generator().manual_seed(0), LAYERS), "step": 3}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state, blocking=True, plan=json.loads(json.dumps(plan_manifest(pipe_plan))))
    restored = mgr.restore(state)
    check_state_matches(restored, state)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(restored["params"], state["params"])
               for k in b) and restored["step"] == 3
    stored = plan_from_manifest(mgr.plan_of())
    assert stored == pipe_plan and stored.stages == pipe_plan.stages
    check_state_matches(restored, {"params": init_stack_params(torch.Generator().manual_seed(1),
                                                               spatial_plan.layers), "step": 0})


# ---------------------------------------------------------------------------
# replan_stack, and its parity with the reference's
# ---------------------------------------------------------------------------


def test_replan_stack_rebalances_for_survivors():
    cluster = parse_cluster_spec("pi3x3+jetson", 2, 2)
    plan = build_stack_plan((64, 64), LAYERS, 2, 2, hw=cluster)
    assert not plan.is_uniform
    new = replan_stack(plan, drop_device(cluster, "jetson"))
    assert (new.n, new.m) == (1, 3)
    assert new.layers == plan.layers and new.input_hw == plan.input_hw
    sizes = np.diff(new.partition.col_bounds)
    assert max(sizes) - min(sizes) <= 2


def test_replan_stack_needs_grid_for_profile_hw():
    plan = build_stack_plan((64, 64), LAYERS, 2, 2)
    with pytest.raises(ValueError, match="needs n, m"):
        replan_stack(plan, "pi3-core")
    new = replan_stack(plan, "pi3-core", 1, 2)
    assert (new.n, new.m) == (1, 2)


def test_replan_stack_degrades_infeasible_grouping():
    cluster = parse_cluster_spec("pi3x3+jetson", 2, 2)
    plan = build_stack_plan((96, 96), LAYERS, 2, 2, hw=cluster)
    new = replan_stack(plan, cluster, groups="auto", crossover="auto")
    assert all(g.end == g.start for g in new.groups if g.mode == "spatial")


def _yolo(depth, bn=True):
    jl = tuple(jax_yolo_layers(batch_norm=bn)[:depth])
    return jl, tuple(LayerDef(**dataclasses.asdict(l)) for l in jl)


def _replan_case(case, pkg):
    """One elastic replan, built from the same inputs by the reference's
    functions (``pkg == "jax"``) or the port's: (old plan, new plan, new
    cluster)."""
    j = pkg == "jax"
    build, parse = (jbuild, jparse) if j else (build_stack_plan, parse_cluster_spec)
    drop, add, replan = (jdrop, jadd, jreplan) if j else (drop_device, add_device, replan_stack)
    backend = ("pallas" if j else "cuda")
    if case == "drop":
        jl, tl = _yolo(8)
        cl = parse("pi3x3+jetson", 2, 2)
        old = build((64, 64), jl if j else tl, 2, 2, "auto", hw=cl, batch=4, backend=backend)
        new_cl = drop(cl, "jetson")
        return old, replan(old, new_cl, batch=4), new_cl
    if case == "add":
        jl, tl = _yolo(8)
        cl = parse("pi3x3", 1, 3)
        old = build((64, 64), jl if j else tl, 1, 3, hw=cl, batch=4, backend=backend)
        new_cl = add(cl, "jetson")
        return old, replan(old, new_cl, batch=4), new_cl
    if case == "degrade":
        cl = parse("pi3x3+jetson", 2, 2)
        old = build((96, 96), JLAYERS if j else LAYERS, 2, 2, hw=cl, backend=backend)
        return old, replan(old, cl, groups="auto", crossover="auto"), cl
    jl, tl = _yolo(8, bn=False)                       # a pipeline tail
    cl = parse("pi3x4", 2, 2)
    old = build((64, 64), jl if j else tl, 2, 2, "auto", hw=cl, batch=8, pipeline=2,
                backend=backend)
    new_cl = drop(cl, 0)
    return old, replan(old, new_cl, batch=8), new_cl


@pytest.mark.parametrize("case", ["drop", "add", "degrade", "pipeline"])
def test_replan_stack_and_manifest_equal_the_references(case):
    jold, jnew, jcl = _replan_case(case, "jax")
    told, tnew, tcl = _replan_case(case, "torch")
    if case == "pipeline":
        assert jold.stages and told.stages == jold.stages
    jm = json.loads(json.dumps(jmanifest(jnew, jcl)))
    tm = json.loads(json.dumps(plan_manifest(tnew, tcl)))
    assert (jm.pop("backend"), tm.pop("backend")) == ("pallas", "cuda")
    assert set(jm) == set(tm)
    for k in jm:
        assert tm[k] == jm[k], k
    assert plan_from_manifest(jmanifest(jnew, jcl)) == tnew


# ---------------------------------------------------------------------------
# driver replan path (toy train steps)
# ---------------------------------------------------------------------------


def _toy_state():
    return {"w": torch.zeros((2, 2)), "step": 0}


def _toy_step(log=None, tag=None):
    def step(state, batch):
        if log is not None:
            log.append((tag, state["step"]))
        return ({"w": state["w"] + batch["x"].mean(), "step": state["step"] + 1},
                {"loss": torch.sum(state["w"])})
    return step


def test_driver_replans_on_cluster_change(tmp_path):
    log = []

    def replan(ev):
        assert ev.kind == "drop" and ev.device == "jetson"
        return _toy_step(log, "after"), {"replanned": True}

    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=2, async_ckpt=False)
    rep = run_training(init_state=lambda s: _toy_state(), train_step=_toy_step(log, "before"),
                       make_batch=lambda s: {"x": torch.full((2,), 1.0)}, steps=6, cfg=cfg,
                       faults=FaultInjector("drop:jetson@3"), replan=replan)
    assert rep.replans == 1 and rep.restarts == 0 and rep.steps_done == 6
    assert log == [("before", 0), ("before", 1), ("before", 2),
                   ("after", 3), ("after", 4), ("after", 5)]
    assert CheckpointManager(str(tmp_path)).plan_of() == {"replanned": True}


def test_driver_cluster_change_without_replan_is_fatal(tmp_path):
    cfg = DriverConfig(ckpt_dir=str(tmp_path), async_ckpt=False)
    with pytest.raises(ClusterChange):
        run_training(init_state=lambda s: _toy_state(),
                     train_step=lambda s, b: (s, {"loss": 0.0}), make_batch=lambda s: {},
                     steps=4, cfg=cfg, faults=FaultInjector("drop:jetson@1"))


def test_driver_ckpt_crash_fault_absorbed(tmp_path):
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=2, async_ckpt=False, io_backoff=0.0)
    rep = run_training(init_state=lambda s: _toy_state(),
                       train_step=lambda s, b: ({"w": s["w"], "step": s["step"] + 1},
                                                {"loss": 0.0}),
                       make_batch=lambda s: {}, steps=4, cfg=cfg,
                       faults=FaultInjector("ckpt-crash@1"))
    assert rep.steps_done == 4 and rep.restarts == 0
    assert CheckpointManager(str(tmp_path)).latest_step() == 3


def test_driver_without_ckpt_dir_refuses_checkpoint_faults():
    """``ckpt-crash`` and ``corrupt`` act on checkpoints: without a
    directory they are refused up front, not turned into a step failure."""
    with pytest.raises(ValueError, match="ckpt_dir"):
        run_training(init_state=lambda s: _toy_state(), train_step=_toy_step(),
                     make_batch=lambda s: {"x": torch.ones(2)}, steps=2, cfg=DriverConfig(),
                     faults=FaultInjector("corrupt@1"))


def test_driver_slow_fault_counts_straggler(tmp_path):
    slept = []
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=100, async_ckpt=False)
    rep = run_training(init_state=lambda s: _toy_state(),
                       train_step=lambda s, b: ({"w": s["w"], "step": s["step"] + 1},
                                                {"loss": 0.0}),
                       make_batch=lambda s: {}, steps=10, cfg=cfg,
                       faults=FaultInjector("slow:9@8", sleep=slept.append))
    assert slept == [9.0] and rep.steps_done == 10


def test_driver_fail_fault_restarts(tmp_path):
    cfg = DriverConfig(ckpt_dir=str(tmp_path), ckpt_every=2, async_ckpt=False)
    rep = run_training(init_state=lambda s: _toy_state(), train_step=_toy_step(),
                       make_batch=lambda s: {"x": torch.full((2,), float(s))}, steps=6, cfg=cfg,
                       faults=FaultInjector("fail@4"))
    assert rep.restarts == 1 and rep.steps_done >= 6
    out = CheckpointManager(str(tmp_path)).restore(_toy_state())
    assert float(out["w"][0, 0]) == pytest.approx(sum(range(6))) and out["step"] == 6


# ---------------------------------------------------------------------------
# trainer globalize/validate helpers
# ---------------------------------------------------------------------------


def test_globalize_state_and_check_match():
    st = TrainState({"w": torch.ones((2, 2))}, {"m": torch.zeros((2, 2))}, 5, None)
    host = globalize_state(st)
    assert host.params["w"].device.type == "cpu" and host.step == 5
    assert host.params["w"] is not st.params["w"]
    check_state_matches(host, st)
    like, dev = abstract_of(lambda _: st)
    assert dev == torch.device("cpu") and like.params["w"].device.type == "meta"
    check_state_matches(like, st)
    with pytest.raises(ValueError, match="shape"):
        check_state_matches(host, TrainState({"w": torch.ones((3, 3))},
                                             {"m": torch.zeros((2, 2))}, 5, None))
    with pytest.raises(ValueError):
        check_state_matches(host, TrainState({"v": torch.ones((2, 2))},
                                             {"m": torch.zeros((2, 2))}, 5, None))
    with pytest.raises(ValueError, match="dtype"):
        check_state_matches(host, TrainState({"w": torch.ones((2, 2), dtype=torch.float64)},
                                             {"m": torch.zeros((2, 2))}, 5, None))


# ---------------------------------------------------------------------------
# scripts/check_elastic.py scenario (a) on the port
# ---------------------------------------------------------------------------


def test_check_elastic_headline_on_the_port(tmp_path, capsys):
    """``pi3x3+jetson`` on 2x2 trains 8 steps under the driver, loses the
    Jetson at step 4 and replans onto the survivors' 1x3 grid (the
    launcher's ``make_replan``), checkpointing there; a second driver
    resumes that checkpoint on the original 2x2 cluster plan and runs to
    step 10.  The final params lie within 1e-5 of the uninterrupted untiled
    run, and the checkpoint's plan manifest rebuilds the 1x3 plan."""
    from repro_torch.launch.train import make_batch_fn, make_replan

    layers = 4
    tcfg = TrainConfig(lr=1e-2, optimizer="sgd", warmup=10, steps=100, grad_clip=1.0)
    pcfg = ParallelConfig(grad_accum=1)
    cluster0 = parse_cluster_spec("pi3x3+jetson", 2, 2)
    arch0 = make_yolo_tiled_arch((64, 64), layers, 2, 2, backend="torch", hw=cluster0,
                                 device="cpu")
    assert not arch0.plan.is_uniform
    init0, step0 = make_train_step(arch0, pcfg, tcfg)
    make_batch = make_batch_fn(4, 64, arch0.target_shape(4), SEED, "cpu")
    replan = make_replan(arch0, cluster0, "pi3-core", 4, pcfg, tcfg)
    d = str(tmp_path / "headline")
    kw = dict(init_state=init0, make_batch=make_batch, seed=SEED, device="cpu",
              plan=plan_manifest(arch0.plan, cluster0))
    rep1 = run_training(train_step=step0, steps=8, faults=FaultInjector("drop:jetson@4"),
                        replan=replan, cfg=DriverConfig(ckpt_dir=d, ckpt_every=3,
                                                        async_ckpt=False), **kw)
    live = replan.live["plan"]
    assert rep1.replans == 1 and rep1.steps_done == 8 and (live.n, live.m) == (1, 3)
    assert "replan (drop:jetson): grid=1x3" in capsys.readouterr().out
    mgr = CheckpointManager(d)
    assert plan_from_manifest(mgr.plan_of()) == live
    rep2 = run_training(train_step=step0, steps=10,
                        cfg=DriverConfig(ckpt_dir=d, ckpt_every=3, async_ckpt=False,
                                         resume="always"), **kw)
    assert rep2.resumed_step == 7
    final = mgr.restore(abstract_of(init0)[0], device="cpu")
    assert final.step == 10
    ref_arch = make_yolo_tiled_arch((64, 64), layers, 1, 1, backend="torch", device="cpu")
    ref_init, ref_step = make_train_step(ref_arch, pcfg, tcfg)
    ref = ref_init(SEED)
    for s in range(10):
        ref, _ = ref_step(ref, make_batch(s))
    err = max(float((a[k] - b[k]).abs().max()) for a, b in zip(final.params, ref.params)
              for k in b)
    assert err <= PARAM_ATOL, err


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_resume_always_without_checkpoint_raises(tmp_path):
    from repro_torch.launch.train import main

    with pytest.raises(FileNotFoundError, match="resume='always'"):
        main(["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "32", "--depth", "4",
              "--steps", "1", "--ckpt-dir", str(tmp_path), "--resume", "always"])


def test_reference_launcher_replan_faults_c7():
    """ROADMAP C.7, both halves at the functions the reference's launcher
    calls (``repro/launch/train.py:226-249``): it hands a fault's device
    string to ``drop_device`` as it is, so ``drop:1@2`` (a flat grid index,
    as the fault grammar's docstring allows) raises; and a replan of a
    homogeneous 2x2 grid at batch 8 plans a data tail that the three
    survivors' tiles do not divide (its step then raises "data-mode batch
    split needs the per-microbatch batch (8) divisible by the tile count
    (1x3=3)", a trace of 4 fake devices this test does not pay for).  The
    port's ``make_replan`` reads the index and plans all-spatial there (the
    launcher test above trains through both)."""
    jcl = jparse("pi3-corex4", 2, 2)
    with pytest.raises(ValueError, match="no device '1'"):
        jdrop(jcl, "1")
    jplan = jbuild((32, 32), tuple(jax_yolo_layers()[:4]), 2, 2)
    jnew = jreplan(jplan, jdrop(jcl, 1), batch=8)
    assert jnew.crossover is not None and 8 % (jnew.n * jnew.m)
    from repro_torch.launch.train import make_replan

    arch = make_yolo_tiled_arch((32, 32), 4, 2, 2, device="cpu")
    replan = make_replan(arch, None, "pi3-core", 8, ParallelConfig(), TrainConfig())
    replan(ClusterChange("drop", "1", 2))
    new = replan.live["plan"]
    assert (new.n, new.m, new.crossover) == (1, 3, None)


def test_launcher_drop_then_resume_on_the_cluster(tmp_path, capsys):
    """Chip phase 18's launcher commands at 64 px: the cluster loses the
    Jetson at step 1 under a straggler, a writer crash and a corrupted
    leaf, and a second run resumes to step 6."""
    from repro_torch.launch.train import main

    base = ["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "64", "--depth", "8",
            "--grid", "2", "--cluster", "pi3x3+jetson", "--groups", "auto", "--batch", "4",
            "--grad-accum", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    assert main(base + ["--steps", "4", "--fault-schedule",
                        "drop:jetson@1,slow:0.2@2,ckpt-crash@2,corrupt@3"]) == 0
    out = capsys.readouterr().out
    assert "replan (drop:jetson): grid=1x3 rows=(0, 64) cols=(0, 24, 48, 64)" in out
    assert "done: steps=4 restarts=0 replans=1" in out
    assert main(base + ["--steps", "6", "--resume", "always"]) == 0
    out = capsys.readouterr().out
    assert "done: steps=2 restarts=0 replans=0" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 5


# ---------------------------------------------------------------------------
# the strong parity test (its JAX half has run beside the tests above)
# ---------------------------------------------------------------------------


def test_jax_checkpoint_resumes_in_the_port(jax_resumed, tmp_path):
    """The strong parity test.  JAX's driver checkpoints steps 0-2 of its
    2x2 plan, then resumes a copy to step 4; the port resumes the step-2
    checkpoint on its own 2x2 plan to step 4, within 1e-5 of JAX's params,
    and reads JAX's plan manifest as its own plan (``xla`` -> ``torch``)."""
    proc, d = jax_resumed
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    shutil.copytree(d / "ckpt", tmp_path / "ckpt")
    arch = make_yolo_tiled_arch((HW, HW), 4, 2, 2, backend="torch", device="cpu")
    init_state, step = make_train_step(arch, ParallelConfig(grad_accum=2),
                                       TrainConfig(**PARITY_TCFG))
    from repro_torch.launch.train import make_batch_fn

    finals = []

    def keep(state, batch):
        state, m = step(state, batch)
        finals.append(state)
        return state, m

    rep = run_training(init_state=init_state, train_step=keep,
                       make_batch=make_batch_fn(BATCH, HW, arch.target_shape(BATCH), SEED, "cpu"),
                       steps=5, cfg=DriverConfig(ckpt_dir=str(tmp_path / "ckpt"),
                                                 resume="always"))
    assert rep.resumed_step == 2 and rep.steps_done == 2
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.read_manifest(2)["plan"]["backend"] == "xla"
    assert plan_from_manifest(mgr.read_manifest(2)["plan"]) == arch.plan
    want = np.load(d / "final.npz")
    got = {}
    map_with_path(lambda p, x: got.__setitem__(p, x), finals[-1])
    assert got["step"] == int(want["step"]) == 5 and got["opt/t"] == int(want["opt/t"]) == 5
    errs = {p: float(np.max(np.abs(x.numpy() - want[p])))
            for p, x in got.items() if p.startswith("params/")}
    assert len(errs) == 6 and max(errs.values()) <= PARAM_ATOL, errs


def _resume_on_ranks(group, ckpt_dir):
    """One of 2 ranks: the 2x2 plan on this rank's block resumes the
    checkpoint in ``ckpt_dir`` to step 4; -> its params after each step."""
    from repro_torch.launch.mesh import make_dist_tile_mesh
    from repro_torch.launch.train import make_batch_fn

    torch.set_num_threads(1)
    arch = make_yolo_tiled_arch((HW, HW), 4, 2, 2, backend="torch", device="cpu",
                                mesh=make_dist_tile_mesh(2, 2, "cpu", group))
    init_state, step = make_train_step(arch, ParallelConfig(grad_accum=2),
                                       TrainConfig(**PARITY_TCFG))
    finals = []

    def keep(state, batch):
        state, m = step(state, batch)
        got = {}
        map_with_path(lambda p, x: got.__setitem__(
            p, x.numpy().copy() if isinstance(x, torch.Tensor) else x), state)
        finals.append(got)
        return state, m

    rep = run_training(init_state=init_state, train_step=keep,
                       make_batch=make_batch_fn(BATCH, HW, arch.target_shape(BATCH), SEED, "cpu"),
                       steps=5, cfg=DriverConfig(ckpt_dir=ckpt_dir, resume="always"), group=group)
    return rep.resumed_step, rep.steps_done, finals


def test_jax_checkpoint_resumes_on_two_ranks(jax_resumed, tmp_path):
    """The strong parity test on ranks: JAX's step-2 checkpoint of its 2x2
    plan resumes on 2 gloo ranks (blocks of two tiles; rank 0 restores it
    and broadcasts every leaf) to step 4, within 1e-5 of JAX's params, both
    ranks alike."""
    from repro_torch.parallel.dist import run_ranks

    proc, d = jax_resumed
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    shutil.copytree(d / "ckpt", tmp_path / "ckpt")
    ranks = run_ranks(_resume_on_ranks, 2, "cpu", args=(str(tmp_path / "ckpt"),), timeout=120)
    want = np.load(d / "final.npz")
    for resumed, done, finals in ranks:
        assert (resumed, done) == (2, 2)
        got = finals[-1]
        assert got["step"] == int(want["step"]) == 5 and got["opt/t"] == int(want["opt/t"]) == 5
        errs = {p: float(np.max(np.abs(x - want[p]))) for p, x in got.items()
                if p.startswith("params/")}
        assert len(errs) == 6 and max(errs.values()) <= PARAM_ATOL, errs
    assert all(np.array_equal(ranks[0][2][-1][p], ranks[1][2][-1][p]) for p in ranks[0][2][-1])
