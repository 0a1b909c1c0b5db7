"""The port's pipeline partition mode (DESIGN.md §11) against the JAX
reference: ``tests/test_pipeline_mode.py`` and
``scripts/check_pipeline_parallel.py`` (a)-(e) on the port, on the CPU at
small sizes.

- planner: stages, groups, geometry and manifest equal to the reference's
  (forced counts, ``"auto"`` under the memory lever, a pinned entry, an
  explicit profile) and its named errors (BN in a stage, overlap, a ragged
  prefix, an infeasible count, an explicit profile with ``pipeline=``, an
  inference plan); ``chip_smoke.py``'s ``PIPELINE_PLANS_416`` equal to the
  reference's plans and their launches to ``PIPELINE_LAUNCHES``;
- executor: the loss of ``make_tiled_loss`` and the deferred step with M =
  1, 2, 4 on 1x4 and 2x2, with and without a spatial prefix (one of them
  with BN, through an explicit profile), against JAX's staged plans on its
  mesh (a subprocess with 4 fake devices) and the untiled reference, at
  ``check_pipeline_parallel.py``'s 1e-5; the slots the executor ran equal
  to ``pipeline_schedule_census``, whose bubble is ``bubble_fraction``;
- the memory lever: the filter-dominated stack ``pipeline=None`` refuses
  under ``mem_limit`` trains under ``pipeline="auto"``;
- the named errors of the entry points (batch, microbatch count; the serve
  entry points refuse pipeline plans), a hand-off to the wrong stage rank
  failing the bar, the trainer and the launcher over a pipeline plan.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import fusion as jfu
from repro.core import spatial as jsp
from repro.core.grouping import bubble_fraction
from repro.core.tiling import Group as JGroup
from repro.core.tiling import TilePartition as JTilePartition
from repro.models.yolo import l2_loss_local as jax_l2
from repro.models.yolo import yolov2_16_layers as jax_yolo_layers
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import fusion as tfu
from repro_torch.core import spatial as tsp
from repro_torch.core.grouping import peak_device_memory
from repro_torch.core.tiling import Group, TilePartition
from repro_torch.interop import params_from_jax
from repro_torch.launch import train as train_launcher
from repro_torch.launch.mesh import make_tile_mesh
from repro_torch.models.yolo import l2_loss_local, make_yolo_tiled_arch, yolov2_16_layers
from repro_torch.train.trainer import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5                      # scripts/check_pipeline_parallel.py:47

# scripts/check_pipeline_parallel.py's filter-dominated stack: 1x1 convs at
# 128 channels on a 4x4 map, whose replicated-filter floor binds every
# non-pipeline plan
WIDE = [jsp.LayerDef(3, 1, 3, 128, act="leaky"),
        *[jsp.LayerDef(1, 1, 128, 128, act="leaky") for _ in range(7)]]
WIDE_HW = (4, 4)
FILTER_FLOOR = 2.0 * sum(l.kernel * l.kernel * l.in_channels * l.out_channels * 4 for l in WIDE)
MEM_LIMIT = 0.75 * FILTER_FLOOR
# check_pipeline_parallel.py (b): a spatial prefix feeding a 2-stage tail
LAYERS6 = [jsp.LayerDef(3, 1, 3, 8, act="leaky"), jsp.LayerDef(3, 2, 8, 8, act="leaky"),
           jsp.LayerDef(3, 1, 8, 16, act="leaky"), jsp.LayerDef(3, 1, 16, 16, act="leaky"),
           jsp.LayerDef(3, 1, 16, 16, act="leaky"), jsp.LayerDef(1, 1, 16, 8, act="leaky")]
# the same with BN in the spatial prefix, the tail BN-free
BN_PREFIX = [jsp.LayerDef(3, 1, 3, 8, act="leaky", batch_norm=True, use_bias=False),
             jsp.LayerDef(3, 2, 8, 8, act="leaky", batch_norm=True, use_bias=False),
             *LAYERS6[2:]]

# name: (layers, input hw, grid, groups, planner kwargs, per-microbatch batch)
CASES = {
    "wide1x4": (WIDE, WIDE_HW, (1, 4), "auto",
                dict(crossover="auto", pipeline="auto", batch=4, mem_limit=MEM_LIMIT), 4),
    "yolo1x4": (jax_yolo_layers(batch_norm=False)[:8], (32, 32), (1, 4), "auto",
                dict(crossover=4, pipeline=4, batch=8), 2),
    "prefix2x2": (LAYERS6, (16, 16), (2, 2), "auto", dict(crossover=2, pipeline=2, batch=8), 4),
    "bn_prefix2x2": (BN_PREFIX, (16, 16), (2, 2),
                     [(0, 1, "spatial"), (2, 3, "pipeline"), (4, 5, "pipeline")], {}, 4),
}
MICRO = (1, 2, 4)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _port(layers):
    return [tsp.LayerDef(**l.__dict__) for l in layers]


def _groups(groups, cls):
    return groups if isinstance(groups, str) else [cls(*g) for g in groups]


def _plans(name, backend="torch"):
    layers, hw, (n, m), groups, kw = CASES[name][:5]
    jp = jfu.build_stack_plan(hw, layers, n, m, _groups(groups, JGroup), **kw)
    tp = tfu.build_stack_plan(hw, _port(layers), n, m, _groups(groups, Group), backend=backend,
                              **kw)
    return jp, tp


def _case_data(name):
    layers, hw, _, _, _, b_mu = CASES[name]
    seed = sorted(CASES).index(name)
    params = jsp.init_stack_params(jax.random.PRNGKey(seed), layers)
    rng = np.random.default_rng(seed)
    out_hw = jfu.build_stack_plan(hw, layers, 1, 1).map_hw[-1]
    xs = rng.standard_normal((max(MICRO), b_mu, *hw, layers[0].in_channels)).astype(np.float32)
    ts = rng.standard_normal((max(MICRO), b_mu, *out_hw, layers[-1].out_channels)
                             ).astype(np.float32)
    return [{k: np.asarray(v) for k, v in p.items()} for p in params], xs, ts


def _leaves(params):
    return [v for p in params for v in p.values()]


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_plans_equal_the_references(name):
    """Groups, modes, stages, geometry and the manifest (but for the backend
    name) equal the reference's."""
    jp, tp = _plans(name)
    assert tp.stages and tp.stages == jp.stages
    assert [(g.start, g.end, g.mode) for g in tp.groups] == \
        [(g.start, g.end, g.mode) for g in jp.groups]
    for f in ("map_hw", "shard_hw", "group_halos", "rem_halos", "group_of_layer", "tile_rows",
              "tile_cols", "crossover", "pipeline_first", "n_stages", "spatial_last",
              "is_uniform", "schedule"):
        assert getattr(tp, f) == getattr(jp, f), f
    want = jfu.plan_manifest(jp)
    got = json.loads(json.dumps(tfu.plan_manifest(tp)))
    assert {k: v for k, v in got.items() if k != "backend"} == \
        {k: v for k, v in json.loads(json.dumps(want)).items() if k != "backend"}
    assert got["stages"] == [list(s) for s in jp.stages]


def test_memory_lever_refuses_without_a_tail_and_plans_one_under_auto():
    """check_pipeline_parallel.py (a), planner half: under a mem_limit below
    the replicated-filter floor every non-pipeline candidate is refused; the
    auto plan has stage-local filters under the limit."""
    for mod in (jfu, tfu):
        layers = WIDE if mod is jfu else _port(WIDE)
        with pytest.raises(ValueError, match="no grouping/crossover/pipeline"):
            mod.build_stack_plan(WIDE_HW, layers, 1, 4, "auto", crossover="auto", batch=4,
                                 mem_limit=MEM_LIMIT)
    _, tp = _plans("wide1x4")
    mem = peak_device_memory(WIDE_HW, tp.layers, tp.groups, 1, 4, batch=4)
    assert mem["total"] <= MEM_LIMIT and mem["filters"] < FILTER_FLOOR


def _both_raise(match, *args, **kw):
    """The reference's planner and the port's raise the same ValueError."""
    msgs = []
    for mod, gcls, pcls in ((jfu, JGroup, JTilePartition), (tfu, Group, TilePartition)):
        hw, layers, n, m, groups = args
        layers = layers if mod is jfu else _port(layers)
        kw2 = dict(kw)
        if "partition" in kw2:
            kw2["partition"] = pcls(*kw2["partition"])
        with pytest.raises(ValueError, match=match) as e:
            mod.build_stack_plan(hw, layers, n, m, _groups(groups, gcls), **kw2)
        msgs.append(str(e.value))
    return msgs


ERRORS = {
    "bn_in_stage": (("batch_norm=True inside a pipeline stage",
                     ((64, 64), jax_yolo_layers()[:6], 1, 4, "auto"), dict(pipeline=2))),
    "overlap": (("cannot combine with a pipeline tail",
                 (WIDE_HW, WIDE, 1, 4, "auto"), dict(schedule="overlap", pipeline=2))),
    "overlap_profile": (("cannot combine with a pipeline tail",
                         (WIDE_HW, WIDE, 1, 4, [(0, 3, "pipeline"), (4, 7, "pipeline")]),
                         dict(schedule="overlap"))),
    "explicit_groups": (("groups='auto'",
                         (WIDE_HW, WIDE, 1, 4, [(0, 7)]), dict(pipeline=2))),
    "ragged_prefix": (("uniform tile partition",
                       ((16, 16), LAYERS6, 2, 2, [(0, 1), (2, 3, "pipeline"), (4, 5, "pipeline")]),
                       dict(partition=((0, 10, 16), (0, 8, 16))))),
    "infeasible_count": (("cannot map onto",
                          (WIDE_HW, WIDE, 2, 2, "auto"), dict(pipeline=4))),
    "infeasible_profile": (("pipeline stages are infeasible",
                            ((16, 16), LAYERS6, 2, 2, [(0, 1), (2, 2, "pipeline"),
                                                       (3, 3, "pipeline"), (4, 5, "pipeline")]),
                            {})),
    "inference": (("inference plans cannot carry a pipeline tail",
                   (WIDE_HW, WIDE, 1, 4, "auto"), dict(pipeline=2, inference=True))),
    "inference_profile": (("inference plans cannot carry pipeline-mode groups",
                           (WIDE_HW, WIDE, 1, 4, [(0, 3, "pipeline"), (4, 7, "pipeline")]),
                           dict(inference=True))),
}


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_named_planner_errors_are_the_references(name):
    match, args, kw = ERRORS[name]
    _both_raise(match, *args, **kw)


def test_serve_entry_points_refuse_pipeline_plans():
    _, tp = _plans("wide1x4")
    mesh = make_tile_mesh(1, 4, "cpu")
    with pytest.raises(ValueError, match="pipeline plans have no single-shot forward layout"):
        tfu.make_tiled_forward(tp, mesh)
    with pytest.raises(ValueError, match="make_tiled_infer needs a forward-only plan"):
        tfu.make_tiled_infer(tp, mesh)
    with pytest.raises(ValueError, match="pipeline plans have no inference twin"):
        tp.inference_twin()


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["pipe2x2", "pipe1x4", "pure1x4"])
def test_phase15_plans_416_equal_the_references(name):
    """The plans ``chip_smoke.py``'s phase 15 trains (``PIPELINE_PLANS_416``)
    are the reference's: groups, stages, geometry; their launches per
    microbatch are ``PIPELINE_LAUNCHES``.  ``pipeline="auto"`` picks no tail
    for this stack at 416 under any profile, so the plans force the count."""
    cs = _chip_smoke()
    (n, m), s, mb, want_groups, want_stages = cs.PIPELINE_PLANS_416[name]
    kw = cs.pipeline_kw(s, mb)
    groups = kw.pop("groups")
    jp = jfu.build_stack_plan((416, 416), jax_yolo_layers(batch_norm=False), n, m, groups, **kw)
    tp = tfu.build_stack_plan((416, 416), yolov2_16_layers(batch_norm=False), n, m, groups,
                              device="cpu", **kw)
    got = [(g.start, g.end, g.mode) for g in tp.groups]
    assert got == [(g.start, g.end, g.mode) for g in jp.groups] == [tuple(g) for g in want_groups]
    assert tp.stages == jp.stages == tuple(map(tuple, want_stages))
    for f in ("map_hw", "shard_hw", "group_halos", "tile_rows", "tile_cols"):
        assert getattr(tp, f) == getattr(jp, f), f
    per_mb, _ = cs.launches_per_batch(tp, 8 // mb)
    assert per_mb == cs.PIPELINE_LAUNCHES
    auto = jfu.build_stack_plan((416, 416), jax_yolo_layers(batch_norm=False), n, m, "auto",
                                hw=cs.PIPELINE_HW, batch=8, pipeline="auto", microbatches=mb)
    assert not auto.stages


# ---------------------------------------------------------------------------
# executor against JAX's staged plans and the untiled reference
# ---------------------------------------------------------------------------

_JAX_PIPE = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from repro.core.fusion import build_stack_plan, make_deferred_grad_step, make_tiled_loss
    from repro.core.spatial import LayerDef
    from repro.core.tiling import Group
    from repro.launch.mesh import make_tile_mesh
    from repro.models.yolo import l2_loss_local
    CASES, MICRO = %r
    d = dict(np.load(sys.argv[1]))
    out = {}
    for name, (layers, hw, grid, groups, kw) in CASES.items():
        layers = [LayerDef(**l) for l in layers]
        groups = groups if isinstance(groups, str) else [Group(*g) for g in groups]
        plan = build_stack_plan(tuple(hw), layers, *grid, groups, **kw)
        mesh = make_tile_mesh(*grid)
        params = [{k: d[f"{name}/p{i}_{k}"] for k in ("w", "b", "bn_scale", "bn_bias")
                   if f"{name}/p{i}_{k}" in d} for i in range(len(layers))]
        xs, ts = d[f"{name}/xs"], d[f"{name}/ts"]
        loss_fn = make_tiled_loss(plan, mesh, l2_loss_local)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params, xs[0], ts[0])
        out[f"{name}/loss"] = np.asarray(loss)
        for i, g in enumerate(grads):
            for k, v in g.items():
                out[f"{name}/loss_g{i}_{k}"] = np.asarray(v)
        for mb in MICRO:
            step = make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=mb)
            loss, grads = jax.jit(step)(params, xs[:mb], ts[:mb])
            out[f"{name}/m{mb}/loss"] = np.asarray(loss)
            for i, g in enumerate(grads):
                for k, v in g.items():
                    out[f"{name}/m{mb}/g{i}_{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def jax_pipe(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    inputs = {}
    for name in CASES:
        params, xs, ts = _case_data(name)
        inputs[f"{name}/xs"], inputs[f"{name}/ts"] = xs, ts
        for i, p in enumerate(params):
            for k, v in p.items():
                inputs[f"{name}/p{i}_{k}"] = v
    np.savez(tmp / "in.npz", **inputs)
    cases = {name: ([l.__dict__ for l in layers], list(hw), list(grid), groups, kw)
             for name, (layers, hw, grid, groups, kw, _) in CASES.items()}
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", _JAX_PIPE % ((cases, MICRO),), tmp / "in.npz",
                    tmp / "out.npz"], env=env, check=True, timeout=600)
    return dict(np.load(tmp / "out.npz"))


def _reference(params, xs, ts, plan):
    """The untiled loss and grads of M microbatches, each with its own BN
    statistics, averaged (equal counts): what the deferred step computes."""
    tp = [{k: v.requires_grad_(True) for k, v in p.items()} for p in params_from_jax(params, "cpu")]
    loss = sum(tfu.reference_loss(tp, torch.from_numpy(x), torch.from_numpy(t), plan, l2_loss_local)
               for x, t in zip(xs, ts)) / len(xs)
    return loss.item(), torch.autograd.grad(loss, _leaves(tp))


def _close(got_loss, got_grads, want_loss, want_grads):
    assert abs(got_loss - want_loss) < TOL, (got_loss, want_loss)
    for a, b in zip(got_grads, want_grads):
        assert float((torch.as_tensor(a) - torch.as_tensor(b)).abs().max()) < TOL


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_loss_matches_jax_and_the_untiled_reference(jax_pipe, name):
    """``make_tiled_loss`` (the tick executor with M=1) and its gradients."""
    params, xs, ts = _case_data(name)
    _, plan = _plans(name, backend="cuda")
    tp = [{k: v.requires_grad_(True) for k, v in p.items()} for p in params_from_jax(params, "cpu")]
    loss_fn = tfu.make_tiled_loss(plan, make_tile_mesh(plan.n, plan.m, "cpu"), l2_loss_local)
    loss = loss_fn(tp, xs[0], ts[0])
    grads = torch.autograd.grad(loss, _leaves(tp))
    want = [jax_pipe[f"{name}/loss_g{i}_{k}"] for i, p in enumerate(params) for k in p]
    _close(loss.item(), grads, float(jax_pipe[f"{name}/loss"]), want)
    _close(loss.item(), grads, *_reference(params, xs[:1], ts[:1], plan))
    census = tfu.pipeline_schedule_census(plan.n_stages, 1)
    assert loss_fn.census == {"ticks": census["ticks"], "busy_slots": census["busy_slots"],
                              "prefix_passes": 1}


@pytest.mark.parametrize("mb", MICRO)
@pytest.mark.parametrize("name", sorted(CASES))
def test_pipeline_deferred_step_matches_jax_and_the_untiled_reference(jax_pipe, name, mb):
    """The deferred step with M microbatches streamed through the stages:
    one walk of the tick schedule and one reverse walk, one division by
    the count."""
    params, xs, ts = _case_data(name)
    _, plan = _plans(name, backend="cuda")
    step = tfu.make_deferred_grad_step(plan, make_tile_mesh(plan.n, plan.m, "cpu"),
                                       l2_loss_local, microbatches=mb)
    loss, grads = step(params_from_jax(params, "cpu"), xs[:mb], ts[:mb])
    got = _leaves(grads)
    want = [jax_pipe[f"{name}/m{mb}/g{i}_{k}"] for i, p in enumerate(params) for k in p]
    _close(float(loss), got, float(jax_pipe[f"{name}/m{mb}/loss"]), want)
    _close(float(loss), got, *_reference(params, xs[:mb], ts[:mb], plan))
    census = tfu.pipeline_schedule_census(plan.n_stages, mb)
    assert step.census == {"ticks": census["ticks"], "busy_slots": census["busy_slots"],
                           "prefix_passes": mb}


@pytest.mark.parametrize("stages", [2, 3, 4])
@pytest.mark.parametrize("mb", [1, 2, 4, 8])
def test_census_is_the_bubble_model_and_the_executors_own_count(stages, mb):
    """``pipeline_schedule_census`` equals the reference's and the cost
    model's (S-1)/(S-1+M) exactly, and the executor runs exactly its busy
    slots and ticks (WIDE on a 1 x (S or 4) grid, M microbatches)."""
    cen = tfu.pipeline_schedule_census(stages, mb)
    assert cen == jfu.pipeline_schedule_census(stages, mb)
    assert cen["busy_slots"] == stages * mb and cen["idle_slots"] == stages * (stages - 1)
    assert cen["bubble"] == bubble_fraction(stages, mb)
    m = 3 if stages == 3 else 4
    hw = (4, 2 * m)
    plan = tfu.build_stack_plan(hw, _port(WIDE), 1, m, "auto", pipeline=stages, batch=4)
    assert plan.n_stages == stages
    per = m // stages
    rng = np.random.default_rng(stages * 10 + mb)
    xs = torch.from_numpy(rng.standard_normal((mb, per, *hw, 3)).astype(np.float32))
    ts = torch.from_numpy(rng.standard_normal((mb, per, *hw, 128)).astype(np.float32))
    params = tsp.init_stack_params(torch.Generator().manual_seed(0), plan.layers)
    step = tfu.make_deferred_grad_step(plan, make_tile_mesh(1, m, "cpu"), l2_loss_local,
                                       microbatches=mb)
    step(params, xs, ts)
    assert step.census == {"ticks": cen["ticks"], "busy_slots": cen["busy_slots"],
                           "prefix_passes": mb}


def test_memory_lever_plan_trains_to_the_untiled_reference():
    """check_pipeline_parallel.py (a), executor half: the auto plan under the
    limit trains on the 1x4 grid, M=4, within 1e-5 of the untiled loss and
    gradients."""
    _, plan = _plans("wide1x4", backend="cuda")
    params, xs, ts = _case_data("wide1x4")
    step = tfu.make_deferred_grad_step(plan, make_tile_mesh(1, 4, "cpu"), l2_loss_local,
                                       microbatches=4)
    loss, grads = step(params_from_jax(params, "cpu"), xs, ts)
    _close(float(loss), _leaves(grads), *_reference(params, xs, ts, plan))


def test_a_handoff_to_the_wrong_stage_rank_fails_the_bar(monkeypatch):
    """The planted fault of ``chip_smoke.py``'s phase 15: a hand-off shifted
    one stage rank too far (each stage tile receives the block of the rank
    before its own, the first rank zeros) moves every gradient leaf past
    the 1e-5 bar."""
    params, xs, ts = _case_data("prefix2x2")
    _, plan = _plans("prefix2x2", backend="cuda")
    real = tfu._stage_handoff

    def wrong_rank(y, plan_, s, wire=None):
        out = real(y, plan_, s, wire).reshape(2, -1, *y.shape[1:])
        return torch.cat([torch.zeros_like(out[:1]), out[:-1]]).reshape(-1, *y.shape[1:])

    monkeypatch.setattr(tfu, "_stage_handoff", wrong_rank)
    step = tfu.make_deferred_grad_step(plan, make_tile_mesh(2, 2, "cpu"), l2_loss_local,
                                       microbatches=2)
    _, grads = step(params_from_jax(params, "cpu"), xs[:2], ts[:2])
    _, want = _reference(params, xs[:2], ts[:2], plan)
    errs = [float((a - b).abs().max()) for a, b in zip(_leaves(grads), want)]
    assert all(e > TOL for e in errs), errs


def test_entry_point_errors_are_named():
    """check_pipeline_parallel.py (d): a microbatch that does not divide over
    a stage's tiles, a wrong microbatch count.  (The port's virtual mesh has
    no batch axis, so the reference's ``batch_axis`` refusal has no
    counterpart.)"""
    _, plan = _plans("wide1x4")
    mesh = make_tile_mesh(1, 4, "cpu")
    params = tsp.init_stack_params(torch.Generator().manual_seed(0), plan.layers)
    step = tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=2)
    with pytest.raises(ValueError, match="divisible by the devices per stage"):
        step(params, torch.zeros(2, 3, *WIDE_HW, 3), torch.zeros(2, 3, *WIDE_HW, 128))
    with pytest.raises(ValueError, match="built for microbatches=2"):
        step(params, torch.zeros(3, 4, *WIDE_HW, 3), torch.zeros(3, 4, *WIDE_HW, 128))
    with pytest.raises(ValueError, match="divisible by the devices per stage"):
        tfu.make_tiled_loss(plan, mesh, l2_loss_local)(params, torch.zeros(3, *WIDE_HW, 3),
                                                       torch.zeros(3, *WIDE_HW, 128))


# ---------------------------------------------------------------------------
# trainer and launcher
# ---------------------------------------------------------------------------


def test_trainer_over_a_pipeline_plan_lowers_the_loss():
    """check_pipeline_parallel.py (e): the trainer tail over a pipeline plan
    drives the loss down; its batch guard names the rule."""
    arch = make_yolo_tiled_arch((32, 32), depth=6, n=1, m=4, groups="auto", pipeline=2, batch=8,
                                batch_norm=False, microbatches=2, device="cpu")
    assert arch.plan.stages
    init_state, train_step = make_train_step(
        arch, ParallelConfig(grad_accum=2),
        TrainConfig(lr=1e-2, optimizer="sgd", warmup=2, steps=20))
    state = init_state(0)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(8, 32, 32, 3, generator=g)
    t = 0.05 * torch.randn(arch.target_shape(8), generator=g)
    losses = []
    for _ in range(4):
        state, metrics = train_step(state, {"x": x, "t": t})
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert train_step.grad_step.census["busy_slots"] == 4
    with pytest.raises(ValueError, match="devices per stage"):
        train_step(state, {"x": x[:6], "t": t[:6]})


def test_launcher_plans_and_trains_a_pipeline_on_cpu(capsys):
    assert train_launcher.main([
        "--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "64", "--depth", "8",
        "--grid", "2", "--groups", "auto", "--hw-profile", "jetson-nano-gpu", "--pipeline", "2",
        "--no-batch-norm", "--batch", "8", "--grad-accum", "2", "--steps", "1"]) == 0
    out = capsys.readouterr().out
    assert "stages=((0, 2), (2, 4))" in out and "steps=1 restarts=0" in out
    with pytest.raises(SystemExit, match="--pipeline must be 'none', 'auto', or a stage count"):
        train_launcher.main(["--arch", "yolov2-tiled", "--device", "cpu", "--pipeline", "two"])
