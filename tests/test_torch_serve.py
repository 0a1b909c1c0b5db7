"""The port's serving slice against the JAX reference.

- planner: ``build_stack_plan`` gives the reference's geometry and manifest;
- executor: the port's 2x2 ``make_tiled_infer`` (virtual mesh, both conv
  backends on the CPU) against JAX's untiled ``stack_reference(inference=
  True)`` in process, and against JAX's own 2x2 ``make_tiled_infer`` with
  ``backend="pallas"`` in a subprocess with 4 fake devices;
- engine: bucket choice, ManualClock deadlines, cache hits and misses,
  refusal of training plans and of params without frozen stats.
Tolerance atol=1e-5 (tests/test_serve_cnn.py)."""
import dataclasses
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
from repro.core import grouping as jg
from repro.core import spatial as jsp
from repro.core.tiling import Group as JGroup
from repro.core.tiling import TilePartition as JTilePartition
from repro.models.yolo import yolov2_16_layers as jax_yolo_layers
from repro.serve import cnn_engine as jengine
from repro_torch.core import fusion as tfu
from repro_torch.core import grouping as tg
from repro_torch.core import spatial as tsp
from repro_torch.core.tiling import Group, TilePartition
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_tile_mesh
from repro_torch.models.yolo import make_yolo_tiled_arch, yolov2_16_layers
from repro_torch.runtime.driver import run_serving
from repro_torch.serve.cnn_engine import CNNServeEngine, ManualClock, modeled_step_bound
from repro_torch.serve.exec_cache import ExecutableCache, plan_cache_key

ATOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NARROW = [
    jsp.LayerDef(3, 1, 3, 8, act="leaky", batch_norm=True, use_bias=False),
    jsp.LayerDef(2, 2, 8, 8, pool=True, act="linear"),
    jsp.LayerDef(3, 1, 8, 6, act="relu"),
    jsp.LayerDef(1, 1, 6, 5, act="leaky"),
    jsp.LayerDef(3, 1, 5, 4, act="linear", batch_norm=True),
]


def _port(layers):
    return [tsp.LayerDef(**dataclasses.asdict(l)) for l in layers]


def _jax_frozen(layers, hw, seed=0, calib_batch=4):
    params = jsp.init_stack_params(jax.random.PRNGKey(seed), layers)
    calib = np.random.default_rng(seed).standard_normal((calib_batch, *hw, 3)).astype(np.float32)
    frozen = jsp.freeze_bn_stats(params, layers, calib)
    return [{k: np.asarray(v) for k, v in p.items()} for p in frozen]


SERVE_CASES = {
    # name: (jax layers, input hw, groups)
    "yolo6-none": (jax_yolo_layers()[:6], (32, 32), None),
    "yolo6-fused": (jax_yolo_layers()[:6], (32, 32), [(0, 3), (4, 5)]),
    "narrow-none": (NARROW, (16, 16), None),
    "narrow-fused": (NARROW, (16, 16), [(0, 2), (3, 4)]),
}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_tiled_infer_2x2_matches_jax_untiled(case, backend):
    layers, hw, groups = SERVE_CASES[case]
    jparams = _jax_frozen(layers, hw)
    x = np.random.default_rng(7).standard_normal((3, *hw, 3)).astype(np.float32)
    want = np.asarray(jsp.stack_reference(x, jparams, layers, inference=True))
    plan = tfu.build_stack_plan(
        hw, _port(layers), 2, 2, None if groups is None else [Group(s, e) for s, e in groups],
        backend=backend, inference=True,
    )
    infer = tfu.make_tiled_infer(plan, make_tile_mesh(2, 2, "cpu"))
    got = infer(params_from_jax(jparams, "cpu"), x).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    # and the port's own untiled reference agrees
    ref = tfu.reference_forward(params_from_jax(jparams, "cpu"), torch.from_numpy(x), plan)
    np.testing.assert_allclose(ref.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_plan_geometry_and_manifest_match_jax(case):
    layers, hw, groups = SERVE_CASES[case]
    jg = None if groups is None else [JGroup(s, e) for s, e in groups]
    tg = None if groups is None else [Group(s, e) for s, e in groups]
    jp = jfu.build_stack_plan(hw, layers, 2, 2, jg, backend="pallas", inference=True)
    tp = tfu.build_stack_plan(hw, _port(layers), 2, 2, tg, backend="cuda", inference=True)
    for f in ("map_hw", "shard_hw", "group_halos", "rem_halos", "group_of_layer",
              "tile_rows", "tile_cols", "input_hw", "n", "m"):
        assert getattr(tp, f) == getattr(jp, f), f
    jm = jfu.plan_manifest(jp)
    tm = tfu.plan_manifest(tp)
    assert tm.pop("backend") == "cuda" and jm.pop("backend") == "pallas"
    assert json.dumps(tm, sort_keys=True) == json.dumps(jm, sort_keys=True)


_JAX_PALLAS_2X2 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.core.fusion import build_stack_plan, make_tiled_infer
    from repro.core.spatial import freeze_bn_stats, init_stack_params
    from repro.core.tiling import Group
    from repro.launch.mesh import make_tile_mesh
    from repro.models.yolo import yolov2_16_layers
    layers = yolov2_16_layers()[:6]
    params = init_stack_params(jax.random.PRNGKey(0), layers)
    rng = np.random.default_rng(0)
    calib = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    params = freeze_bn_stats(params, layers, calib)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    plan = build_stack_plan((32, 32), layers, 2, 2, [Group(0, 3), Group(4, 5)],
                            backend="pallas", inference=True)
    y = make_tiled_infer(plan, make_tile_mesh(2, 2))(params, x)
    out = {"x": x, "y": np.asarray(y)}
    for i, p in enumerate(params):
        for k, v in p.items():
            out[f"p{i}_{k}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")


def test_port_matches_jax_pallas_2x2_infer_subprocess(tmp_path):
    out = tmp_path / "jax_pallas_2x2.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", _JAX_PALLAS_2X2, str(out)], env=env,
                   check=True, timeout=600)
    d = np.load(out)
    layers = yolov2_16_layers()[:6]
    params = [{} for _ in layers]
    for key in d.files:
        if key.startswith("p"):
            i, k = key[1:].split("_", 1)
            params[int(i)][k] = d[key]
    for backend in ("cuda", "torch"):
        arch = make_yolo_tiled_arch((32, 32), 6, 2, 2, [Group(0, 3), Group(4, 5)],
                                    backend=backend, device="cpu")
        infer = tfu.make_tiled_infer(arch.serve_plan(), arch.mesh)
        got = infer(params_from_jax(params, "cpu"), d["x"]).numpy()
        np.testing.assert_allclose(got, d["y"], atol=ATOL)


# The planning modes of ROADMAP A.10 (overlap), A.11 (hybrid plans) and
# A.12 (non-uniform partitions: a heterogeneous cluster's balanced one, an
# explicit one), which raised before the port ran them: (kwargs, schedule
# and crossover of the plan they now give).
PORTED_MODES = [
    (dict(schedule="auto", hw="pi3-core", device="cuda"), ("overlap", None)),
    (dict(groups="auto", crossover="auto"), ("sync", None)),
    (dict(schedule="overlap"), ("overlap", None)),
    (dict(crossover=2), ("sync", 2)),
    (dict(groups=[Group(0, 1), Group(2, 3, "data")]), ("sync", 2)),
    (dict(hw="pi3x3+jetson"), ("sync", None)),
    (dict(groups="auto", hw="jetson+pi3x3"), ("sync", None)),
    (dict(partition=TilePartition((0, 24, 32), (0, 16, 32))), ("sync", None)),
]


def _plan_mode(kw, **extra):
    kw = dict(kw, **extra)
    groups = kw.pop("groups", None)
    return tfu.build_stack_plan((32, 32), yolov2_16_layers()[:4], 2, 2, groups, **kw)


def test_unported_planning_modes_raise_with_roadmap_item():
    layers = yolov2_16_layers()[:4]
    # the A.14 case now plans and serves: the int8 plan's serve twin runs
    # through the engine, each response its own compressed forward of the
    # dispatched batch, a quantisation away from the uncompressed one
    plan8 = tfu.build_stack_plan((32, 32), layers, 2, 2, wire_codec="int8", inference=True)
    assert plan8.wire_codec == "int8" and tfu.plan_manifest(plan8)["wire_codec"] == "int8"
    mesh = make_tile_mesh(2, 2, "cpu")
    rng = np.random.default_rng(0)
    frozen = tsp.freeze_bn_stats(tsp.init_stack_params(torch.Generator().manual_seed(0), layers),
                                 layers, torch.from_numpy(rng.standard_normal((4, 32, 32, 3)
                                                                              ).astype(np.float32)))
    eng = CNNServeEngine(plan8, mesh, frozen, buckets=(4,), step_bound=0.01, latency_budget=1.0,
                         clock=ManualClock(), simulate_step_s=0.01)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    for im in images:
        eng.submit(im)
    eng.drain()
    assert [b["bucket"] for b in eng.batch_log] == [4]
    got = np.stack([r.result for r in sorted(eng.finished, key=lambda r: r.rid)])
    want = tfu.make_tiled_infer(plan8, mesh)(frozen, torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(got, want)
    none = tfu.make_tiled_infer(dataclasses.replace(plan8, wire_codec="none"), mesh)(
        frozen, torch.from_numpy(images)).numpy()
    assert 0 < np.abs(got - none).max() < 0.05 * np.abs(none).max()
    # the A.13 cases now meet the reference's outcomes: pipeline=2 without
    # groups="auto" is refused, with it the BN layers refuse a stage, and
    # pipeline="auto" plans the reference's groups (no tail for this stack)
    jlayers = jax_yolo_layers()[:4]
    for mod, ls in ((jfu, jlayers), (tfu, layers)):
        with pytest.raises(ValueError, match="pipeline tails are planner-assigned"):
            mod.build_stack_plan((32, 32), ls, 2, 2, pipeline=2)
        with pytest.raises(ValueError, match="batch_norm=True inside a pipeline stage"):
            mod.build_stack_plan((32, 32), ls, 2, 2, "auto", pipeline=2)
    got = tfu.build_stack_plan((32, 32), layers, 2, 2, "auto", pipeline="auto")
    want = jfu.build_stack_plan((32, 32), jlayers, 2, 2, "auto", pipeline="auto")
    assert [(g.start, g.end, g.mode) for g in got.groups] == \
        [(g.start, g.end, g.mode) for g in want.groups]
    assert got.stages == want.stages
    # the A.10, A.11 and A.12 cases now plan (test_ported_planning_modes_run
    # runs them); the A.12 ones plan the reference's ragged partition
    for kw, (schedule, crossover) in PORTED_MODES:
        plan = _plan_mode(kw)
        assert (plan.schedule, plan.crossover) == (schedule, crossover), kw
        if not plan.is_uniform:
            jkw = dict(kw)
            jgroups = jkw.pop("groups", None)
            if "partition" in jkw:
                jkw["partition"] = JTilePartition(*dataclasses.astuple(jkw["partition"]))
            jp = jfu.build_stack_plan((32, 32), jlayers, 2, 2, jgroups, **jkw)
            assert (plan.tile_rows, plan.tile_cols) == (jp.tile_rows, jp.tile_cols), kw
    # the reference's guards stay: overlap with a pipeline tail, a crossover
    # inside a group
    with pytest.raises(ValueError, match="cannot combine with a pipeline tail"):
        tfu.build_stack_plan((32, 32), layers, 2, 2, "auto", schedule="overlap", pipeline=2)
    with pytest.raises(ValueError, match="falls inside group"):
        tfu.build_stack_plan((32, 32), layers, 2, 2, [Group(0, 3)], crossover=2)
    convs = [tsp.LayerDef(3, 1, 3, 3) for _ in range(4)]
    with pytest.raises(ValueError, match="exceeds the smallest tile"):
        tfu.build_stack_plan((6, 6), convs, 2, 2, [Group(0, 3)])
    with pytest.raises(KeyError, match="unknown conv backend"):
        tfu.build_stack_plan((32, 32), layers, 2, 2, backend="pallas")


@pytest.mark.parametrize("i", range(len(PORTED_MODES)))
def test_ported_planning_modes_run(i):
    """Each A.10 / A.11 / A.12 planning mode, under the conditions that
    raised before, now serves: its inference twin on the 2x2 virtual mesh (both
    conv backends on the CPU) equals the untiled frozen-BN forward, and so
    does its training forward."""
    kw, _ = PORTED_MODES[i]
    layers = yolov2_16_layers()[:4]
    params = tsp.init_stack_params(torch.Generator().manual_seed(0), layers)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 32, 32, 3))
                         .astype(np.float32))
    frozen = tsp.freeze_bn_stats(params, layers, x)
    mesh = make_tile_mesh(2, 2, "cpu")
    for backend in ("torch", "cuda"):
        plan = _plan_mode(kw, backend=backend)
        got = tfu.make_tiled_infer(plan.inference_twin(), mesh)(frozen, x)
        want = tfu.reference_forward(frozen, x, plan.inference_twin())
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
        got = tfu.make_tiled_forward(plan, mesh)(params, x)
        np.testing.assert_allclose(got.detach().numpy(),
                                   tfu.reference_forward(params, x, plan).numpy(), atol=ATOL)


# ---------------------------------------------------------------------------
# serving engine (as tests/test_serve_cnn.py, on the port)
# ---------------------------------------------------------------------------

HW = (16, 16)
ELAYERS = [
    tsp.LayerDef(3, 1, 3, 8, act="leaky", batch_norm=True, use_bias=False),
    tsp.LayerDef(2, 2, 8, 8, pool=True, act="linear"),
    tsp.LayerDef(3, 1, 8, 8, act="leaky"),
]


def _serve_setup(n=2, m=2, backend="cuda"):
    plan = tfu.build_stack_plan(HW, ELAYERS, n, m, backend=backend, inference=True)
    mesh = make_tile_mesh(n, m, "cpu")
    params = tsp.init_stack_params(torch.Generator().manual_seed(0), ELAYERS)
    calib = torch.from_numpy(np.random.default_rng(1).standard_normal((4, *HW, 3)).astype(np.float32))
    return plan, mesh, tsp.freeze_bn_stats(params, ELAYERS, calib)


def test_engine_refuses_training_plans_bad_buckets_and_missing_bound():
    train = tfu.build_stack_plan(HW, ELAYERS, 1, 1)
    with pytest.raises(ValueError, match="inference_twin"):
        CNNServeEngine(train, None, [], step_bound=0.1)
    plan, mesh, params = _serve_setup()
    with pytest.raises(ValueError, match="buckets"):
        CNNServeEngine(plan, mesh, params, buckets=(0, 2), step_bound=0.1)
    engine = CNNServeEngine(plan, mesh, params)      # no bound given: the modeled one
    assert engine.step_bound == modeled_step_bound(plan, 8) > 0
    with pytest.raises(ValueError, match="forward-only"):
        tfu.make_tiled_infer(train, mesh)


def test_engine_needs_frozen_stats():
    plan, mesh, _ = _serve_setup()
    raw = tsp.init_stack_params(torch.Generator().manual_seed(0), ELAYERS)
    engine = CNNServeEngine(plan, mesh, raw, buckets=(1,), step_bound=0.1)
    with pytest.raises(ValueError, match="freeze_bn_stats"):
        engine.warmup()


def test_engine_dispatch_policy_and_stats():
    plan, mesh, params = _serve_setup()
    clock = ManualClock()
    engine = CNNServeEngine(
        plan, mesh, params, buckets=(1, 2, 4), latency_budget=10.0,
        step_bound=0.5, clock=clock, simulate_step_s=0.05,
    )
    assert engine.warmup()["misses"] == 3
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((6, *HW, 3)).astype(np.float32)

    engine.submit(imgs[0]); engine.submit(imgs[1])
    assert engine.step() == [] and engine.pending == 2          # waits
    engine.submit(imgs[2]); engine.submit(imgs[3])
    assert [r.rid for r in engine.step()] == [0, 1, 2, 3]       # full bucket
    assert engine.batch_log[-1]["bucket"] == 4

    engine.submit(imgs[4])
    assert engine.step() == []
    clock.advance(10.0 - 2.0 * 0.5 + 0.01)                      # deadline pressure
    assert [r.rid for r in engine.step()] == [4]
    assert engine.batch_log[-1]["bucket"] == 1

    ref = tsp.stack_reference(torch.from_numpy(imgs[:5]), params, ELAYERS, inference=True).numpy()
    for r in engine.finished:
        np.testing.assert_allclose(r.result, ref[r.rid], atol=ATOL)

    engine.submit(imgs[5])
    engine.drain()
    s = engine.stats()
    assert s["served"] == 6 and engine.pending == 0
    assert s["bucket_census"] == {4: 1, 1: 2}
    assert s["cache"]["misses"] == 3 and s["cache"]["hits"] == 3
    assert s["deadline_misses"] == 0 and s["min_slack_s"] > 0
    assert s["p99_s"] >= s["p50_s"] >= 0.0 and s["throughput"] > 0
    with pytest.raises(ValueError, match="shape"):
        engine.submit(np.zeros((8, 8, 3), np.float32))


def test_bucket_choice():
    plan, mesh, params = _serve_setup()
    engine = CNNServeEngine(plan, mesh, params, buckets=(8, 2, 1, 4), step_bound=0.1)
    assert engine.buckets == (1, 2, 4, 8)
    assert [engine._pick_bucket(k) for k in (1, 2, 3, 5, 8, 11)] == [1, 2, 4, 8, 8, 8]


def test_run_serving_driver_reports():
    plan, mesh, params = _serve_setup()
    clock = ManualClock()
    engine = CNNServeEngine(
        plan, mesh, params, buckets=(1, 2), latency_budget=5.0,
        step_bound=0.1, clock=clock, simulate_step_s=0.01,
    )
    engine.warmup()
    rng = np.random.default_rng(1)

    def on_tick(t, eng):
        eng.submit(rng.standard_normal((*HW, 3)).astype(np.float32))
        clock.advance(0.001)

    report = run_serving(engine, ticks=5, on_tick=on_tick)
    assert report.served == 5 and engine.pending == 0
    assert report.deadline_misses == 0 and report.min_slack_s > 0
    assert report.throughput > 0 and report.p99_s >= report.p50_s
    assert sum(report.bucket_census.values()) == report.dispatches
    assert report.cache["misses"] == 2


def test_cache_key_covers_plan_knobs_and_lru():
    base = dict(inference=True)
    plans = [
        tfu.build_stack_plan(HW, ELAYERS, 1, 1, **base),
        tfu.build_stack_plan(HW, ELAYERS, 2, 2, **base),
        tfu.build_stack_plan(HW, ELAYERS, 2, 2, backend="cuda", **base),
        tfu.build_stack_plan(HW, ELAYERS, 2, 2, block_oh=4, **base),
        tfu.build_stack_plan(HW, ELAYERS, 2, 2, [Group(0, 2)], **base),
        tfu.build_stack_plan(HW, ELAYERS, 1, 1),
    ]
    assert len({plan_cache_key(p, 4) for p in plans}) == len(plans)
    assert plan_cache_key(plans[0], 1) != plan_cache_key(plans[0], 2)
    assert plan_cache_key(tfu.build_stack_plan(HW, ELAYERS, 1, 1, **base), 4) == \
        plan_cache_key(plans[0], 4)
    cache = ExecutableCache(capacity=2)
    builds = []
    mk = lambda k: lambda: builds.append(k) or k
    cache.get_or_build("a", mk("a")); cache.get_or_build("b", mk("b"))
    cache.get_or_build("a", mk("a")); cache.get_or_build("c", mk("c"))
    assert cache.keys() == ["a", "c"] and cache.evictions == 1
    assert builds == ["a", "b", "c"]
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 3
    with pytest.raises(ValueError):
        ExecutableCache(capacity=0)


def test_arch_surface_and_launcher_cpu(capsys):
    arch = make_yolo_tiled_arch((32, 32), 4, 2, 2, backend="cuda", device="cpu")
    params = arch.init(0)
    assert params[0]["w"].shape == (3, 3, 3, 32) and arch.out_channels == 64
    assert arch.serve_plan().inference and not arch.plan.inference
    calib = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    engine = arch.make_serve_engine(params, calibration=calib, buckets=(2,), step_bound=0.1)
    assert all("bn_mean" in p for p in engine.params if p)

    from repro_torch.launch.serve import main

    assert main(["--cnn", "--device", "cpu", "--size", "32", "--depth", "4",
                 "--requests", "4", "--ticks", "2", "--buckets", "1", "2"]) == 0
    assert "served 4 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# groups="auto", hardware profiles and clusters, the modeled step bound
# ---------------------------------------------------------------------------

AUTO_HW_CASES = {
    # name: (hw, mem_limit)
    **{p: (p, None) for p in sorted(jg.PROFILES)},
    "cluster-pi3x4": ("pi3x4", None),
    "mem-limit": ("jetson-nano-gpu", 6.0e6),
}


@pytest.mark.parametrize("case", sorted(AUTO_HW_CASES))
def test_auto_plan_manifest_matches_jax(case):
    """``build_stack_plan(groups="auto", hw=...)`` plans what the reference
    plans: the same manifest (with the cluster entry), backend name aside,
    and the same geometry."""
    hw, mem_limit = AUTO_HW_CASES[case]
    layers = jax_yolo_layers()[:8]
    kw = dict(hw=hw, batch=4, mem_limit=mem_limit, microbatches=2)
    jp = jfu.build_stack_plan((64, 64), layers, 2, 2, "auto", backend="pallas", **kw)
    tp = tfu.build_stack_plan((64, 64), _port(layers), 2, 2, "auto", backend="cuda", **kw)
    for f in ("map_hw", "shard_hw", "group_halos", "rem_halos", "group_of_layer",
              "tile_rows", "tile_cols"):
        assert getattr(tp, f) == getattr(jp, f), f
    jc = jg.parse_cluster_spec(hw, 2, 2) if hw.startswith("pi3x") else None
    tc = tg.parse_cluster_spec(hw, 2, 2) if jc is not None else None
    jm, tm = jfu.plan_manifest(jp, jc), tfu.plan_manifest(tp, tc)
    assert tm.pop("backend") == "cuda" and jm.pop("backend") == "pallas"
    assert json.dumps(tm, sort_keys=True) == json.dumps(jm, sort_keys=True)
    if mem_limit is not None:     # the limit binds: unconstrained, one group
        free = tfu.build_stack_plan((64, 64), _port(layers), 2, 2, "auto", hw=hw, batch=4)
        assert len(free.groups) < len(tp.groups)


def test_auto_schedule_resolves_to_sync_on_the_cpu():
    plan = tfu.build_stack_plan((32, 32), yolov2_16_layers()[:4], 2, 2, schedule="auto",
                                hw="pi3-core", device="cpu")
    assert plan.schedule == "sync"
    jplan = jfu.build_stack_plan((32, 32), jax_yolo_layers()[:4], 2, 2, schedule="auto",
                                 hw="pi3-core")
    assert jplan.schedule == "sync"       # the reference on its CPU backend
    # on a card the cost model decides: overlap here, a sync plan elsewhere
    assert tfu._resolve_auto_schedule((32, 32), yolov2_16_layers()[:4], None, 2, 2,
                                      tg.PI3_PROFILE, 1, None, "cuda") == "overlap"
    assert tfu._resolve_auto_schedule((32, 32), yolov2_16_layers()[:4], None, 2, 2,
                                      tg.JETSON_PROFILE, 1, None, "cuda") == "sync"
    plan = tfu.build_stack_plan((32, 32), yolov2_16_layers()[:4], 2, 2, schedule="auto",
                                hw="jetson-nano-gpu", device="cuda")
    assert plan.schedule == "sync"


def test_hw_errors_match_jax():
    layers = yolov2_16_layers()[:4]
    for hw in ("bogus", "pi3x3", "pi3x3+bogus"):
        with pytest.raises((KeyError, ValueError)) as want:
            jfu.build_stack_plan((32, 32), jax_yolo_layers()[:4], 2, 2, "auto", hw=hw)
        with pytest.raises(type(want.value)) as got:
            tfu.build_stack_plan((32, 32), layers, 2, 2, "auto", hw=hw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="groups must be"):
        tfu.build_stack_plan((32, 32), layers, 2, 2, "best")
    with pytest.raises(ValueError, match="unknown wire codec"):
        tfu.build_stack_plan((32, 32), layers, 2, 2, wire_codec="zstd")


@pytest.mark.parametrize("hw", [None, "jetson-nano-gpu", "cluster"])
def test_modeled_step_bound_matches_jax(hw):
    layers = jax_yolo_layers()[:6]
    jp = jfu.build_stack_plan((32, 32), layers, 2, 2, [JGroup(0, 3), JGroup(4, 5)],
                              inference=True)
    tp = tfu.build_stack_plan((32, 32), _port(layers), 2, 2, [Group(0, 3), Group(4, 5)],
                              inference=True)
    jhw, thw = hw, hw
    if hw == "cluster":
        jhw, thw = jg.parse_cluster_spec("pi3x4", 2, 2), tg.parse_cluster_spec("pi3x4", 2, 2)
    for batch in (1, 8):
        assert modeled_step_bound(tp, batch, thw) == jengine.modeled_step_bound(jp, batch, jhw)
    # the engine's default bound is the modeled one at the largest bucket
    mesh = make_tile_mesh(2, 2, "cpu")
    kw = dict(cluster=thw) if hw == "cluster" else dict(hw=thw)
    engine = CNNServeEngine(tp, mesh, [], buckets=(1, 2, 4), **kw)
    assert engine.step_bound == jengine.modeled_step_bound(jp, 4, jhw)
    assert CNNServeEngine(tp, mesh, [], step_bound=0.25, **kw).step_bound == 0.25
    if hw == "cluster":        # the cluster keys the cache too
        assert engine.executable.__self__.cluster is thw
        assert plan_cache_key(tp, 4, thw) != plan_cache_key(tp, 4)
        assert plan_cache_key(tp, 4, thw)[0] == json.dumps(jfu.plan_manifest(jp, jhw) | {
            "backend": "torch"}, sort_keys=True)


def test_serve_launcher_groups_auto_on_cpu(capsys):
    from repro_torch.launch.serve import main

    assert main(["--cnn", "--device", "cpu", "--size", "32", "--depth", "4", "--groups", "auto",
                 "--hw", "jetson-nano-gpu", "--requests", "4", "--ticks", "2",
                 "--buckets", "1", "2"]) == 0
    out = capsys.readouterr().out
    jp = jfu.build_stack_plan((32, 32), jax_yolo_layers()[:4], 2, 2, "auto",
                              hw="jetson-nano-gpu", batch=2)
    bound = jengine.modeled_step_bound(jp.inference_twin(), 2, "jetson-nano-gpu")
    assert f"groups={[(g.start, g.end) for g in jp.groups]}" in out
    assert f"modeled step bound {bound * 1e3:.3f} ms (hw=jetson-nano-gpu)" in out
    assert "served 4 requests" in out
    with pytest.raises(SystemExit):
        main(["--cnn", "--device", "cpu", "--step-bound-ms", "50"])
