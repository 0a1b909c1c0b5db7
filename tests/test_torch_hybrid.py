"""The port's hybrid spatial->data plans (DESIGN.md §7) against the JAX
reference.

- planner: ``build_stack_plan`` with an int, ``"auto"`` or group-carried
  crossover gives the reference's groups, modes, geometry and manifest, and
  ``groups="auto", crossover="auto"`` the reference's plan for the four
  profiles at 416x416, 2x2, batch 8 (pure Python; ``chip_smoke.py``'s
  ``HYBRID_PLANS_416`` is that plan);
- executor: loss and grads on the 2x2 virtual mesh against JAX's untiled
  ``reference_loss`` at a crossover at the input, mid-stack and the last
  layer (``tests/test_hybrid.py:146``: loss rel 1e-5, grads 1e-5), the
  forward element by element against JAX's own 2x2 ``make_tiled_forward``,
  and the microbatched deferred step against JAX's 2x2 one (a subprocess
  with 4 fake devices);
- the named errors: a microbatch that cannot spread over the tiles, a serve
  bucket that cannot.
"""
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
from repro.core import spatial as jsp
from repro.core.tiling import Group as JGroup
from repro.models.yolo import l2_loss_local as jax_l2
from repro.models.yolo import yolov2_16_layers as jax_yolo_layers
from repro_torch.core import fusion as tfu
from repro_torch.core import spatial as tsp
from repro_torch.core.tiling import Group
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_tile_mesh
from repro_torch.models.yolo import l2_loss_local, yolov2_16_layers
from repro_torch.serve.cnn_engine import CNNServeEngine, ManualClock
from repro_torch.serve.exec_cache import plan_cache_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-5          # tests/test_hybrid.py:160-167
FWD_ATOL = 1e-5
HW = (32, 32)
PROFILES = ["jetson-edge-100m", "jetson-nano-gpu", "pi3-core", "tpu-v5e-chip"]

# A YOLOv2 prefix (BN, leaky, 3x3 / 1x1 convs, 2x2 pools) at narrow widths
NARROW_YOLO = [
    jsp.LayerDef(3, 1, 3, 4, act="leaky", batch_norm=True, use_bias=False),
    jsp.LayerDef(2, 2, 4, 4, pool=True, act="linear"),
    jsp.LayerDef(3, 1, 4, 8, act="leaky", batch_norm=True, use_bias=False),
    jsp.LayerDef(2, 2, 8, 8, pool=True, act="linear"),
    jsp.LayerDef(3, 1, 8, 16, act="leaky", batch_norm=True, use_bias=False),
    jsp.LayerDef(1, 1, 16, 8, act="leaky", batch_norm=True, use_bias=False),
    jsp.LayerDef(3, 1, 8, 16, act="leaky", batch_norm=True, use_bias=False),
    jsp.LayerDef(2, 2, 16, 16, pool=True, act="linear"),
]
# BN-free (BN statistics are per microbatch by design), as tests/test_hybrid.py:182
DEFERRED_LAYERS = [
    jsp.LayerDef(3, 1, 3, 8, act="leaky"),
    jsp.LayerDef(2, 2, 8, 8, pool=True, act="linear"),
    jsp.LayerDef(3, 1, 8, 8, act="relu"),
]
# crossover at the input, mid-stack, the last layer
CROSSOVERS = [0, 4, 7]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _port(layers):
    return [tsp.LayerDef(**dataclasses.asdict(l)) for l in layers]


def _np_params(layers, seed=0):
    params = jsp.init_stack_params(jax.random.PRNGKey(seed), layers)
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _out_hw(layers, hw):
    for l in layers:
        hw = (l.out_extent(hw[0]), l.out_extent(hw[1]))
    return hw


def _data(layers, b=4, seed=1, lead=()):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((*lead, b, *HW, 3)).astype(np.float32)
    t = (0.05 * rng.standard_normal((*lead, b, *_out_hw(layers, HW),
                                     layers[-1].out_channels))).astype(np.float32)
    return x, t


def _leaves(params):
    return [v for p in params for v in p.values()]


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

GEOMETRY = ("map_hw", "shard_hw", "group_halos", "rem_halos", "group_of_layer", "tile_rows",
            "tile_cols", "input_hw", "n", "m", "crossover", "schedule")
PLAN_CASES = {
    # name: (layers, input hw, groups, kwargs)
    "crossover-0": (NARROW_YOLO, HW, None, dict(crossover=0)),
    "crossover-4": (NARROW_YOLO, HW, None, dict(crossover=4)),
    "crossover-4-overlap": (NARROW_YOLO, HW, [(0, 3), (4, 7)], dict(crossover=4,
                                                                     schedule="overlap")),
    "crossover-last": (NARROW_YOLO, HW, None, dict(crossover=7)),
    "crossover-all-spatial": (NARROW_YOLO, HW, None, dict(crossover=8)),
    "crossover-auto-explicit": (jax_yolo_layers()[:8], (64, 64), [(0, 3), (4, 5), (6, 7)],
                                dict(crossover="auto", hw="jetson-edge-100m", batch=4)),
    "groups-auto-crossover-auto": (jax_yolo_layers()[:8], (64, 64), "auto",
                                   dict(crossover="auto", hw="jetson-edge-100m", batch=4)),
    "data-groups": (NARROW_YOLO, HW, [(0, 3), (4, 5, "data"), (6, 7, "data")], {}),
    "data-tail-13x13": ([
        jsp.LayerDef(3, 1, 3, 8, act="leaky"),
        jsp.LayerDef(2, 2, 8, 8, pool=True, act="linear"),   # 52 -> 26
        jsp.LayerDef(3, 1, 8, 8, act="relu"),
        jsp.LayerDef(2, 2, 8, 8, pool=True, act="linear"),   # 26 -> 13: grid-ragged
        jsp.LayerDef(3, 1, 8, 8, act="relu"),
    ], (52, 52), None, dict(crossover=3)),
}


def _groups(groups, cls):
    if groups is None or isinstance(groups, str):
        return groups
    return [cls(*g) for g in groups]


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_hybrid_plan_geometry_and_manifest_match_jax(case):
    layers, hw, groups, kw = PLAN_CASES[case]
    jp = jfu.build_stack_plan(hw, layers, 2, 2, _groups(groups, JGroup), backend="pallas", **kw)
    tp = tfu.build_stack_plan(hw, _port(layers), 2, 2, _groups(groups, Group), backend="cuda",
                              **kw)
    for f in GEOMETRY:
        assert getattr(tp, f) == getattr(jp, f), f
    assert [(g.start, g.end, g.mode) for g in tp.groups] == [
        (g.start, g.end, g.mode) for g in jp.groups]
    jm, tm = jfu.plan_manifest(jp), tfu.plan_manifest(tp)
    assert tm.pop("backend") == "cuda" and jm.pop("backend") == "pallas"
    assert json.dumps(tm, sort_keys=True) == json.dumps(jm, sort_keys=True)


def test_data_tail_is_exempt_from_grid_divisibility():
    """52 -> 26 -> 13 on a 2x2 grid: a crossover at the 13x13 layer keeps
    the partition uniform; the all-spatial plan needs a ragged one (ROADMAP
    A.12), which is the reference's and runs: its forward is the untiled
    one."""
    layers, hw, _, kw = PLAN_CASES["data-tail-13x13"]
    plan = tfu.build_stack_plan(hw, _port(layers), 2, 2, **kw)
    assert plan.is_uniform and plan.shard_hw[0] == (26, 26) and plan.shard_hw[4] == (13, 13)
    ragged = tfu.build_stack_plan(hw, _port(layers), 2, 2)
    jp = jfu.build_stack_plan(hw, layers, 2, 2)
    assert not ragged.is_uniform and ragged.tile_rows[-1] == jp.tile_rows[-1] == (7, 6)
    assert (ragged.tile_rows, ragged.tile_cols) == (jp.tile_rows, jp.tile_cols)
    params = params_from_jax(_np_params(layers), "cpu")
    x = np.random.default_rng(7).standard_normal((2, *hw, 3)).astype(np.float32)
    got = tfu.make_tiled_forward(ragged, make_tile_mesh(2, 2, "cpu"))(params, x)
    want = tfu.reference_forward(params, torch.from_numpy(x), ragged)
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=FWD_ATOL)


def _chip_smoke_constant(name):
    import ast

    path = os.path.join(REPO, "chip_smoke.py")
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name
                                                 for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"chip_smoke.py defines no {name}")


@pytest.mark.parametrize("schedule", ["sync", "overlap"])
@pytest.mark.parametrize("hw", PROFILES)
def test_auto_crossover_plans_416_equal_the_references(hw, schedule):
    """``groups="auto", crossover="auto"`` for YOLOv2-16 (BN) at 416x416 on
    2x2, batch 8: the port's plan is the reference's, and the plan
    ``chip_smoke.py`` holds the card to (``HYBRID_PLANS_416``) is the one
    for its schedule."""
    jp = jfu.build_stack_plan((416, 416), jax_yolo_layers(), 2, 2, "auto", hw=hw, batch=8,
                              crossover="auto", schedule=schedule)
    tp = tfu.build_stack_plan((416, 416), yolov2_16_layers(), 2, 2, "auto", hw=hw, batch=8,
                              crossover="auto", schedule=schedule, device="cpu")
    got = [(g.start, g.end, g.mode) for g in tp.groups]
    assert got == [(g.start, g.end, g.mode) for g in jp.groups]
    for f in GEOMETRY:
        assert getattr(tp, f) == getattr(jp, f), f
    want_schedule, want_groups, want_cross = _chip_smoke_constant("HYBRID_PLANS_416")[hw]
    if schedule == want_schedule:
        assert got == [tuple(g) for g in want_groups] and tp.crossover == want_cross


def test_cache_keys_tell_schedules_and_modes_apart():
    layers = _port(NARROW_YOLO)
    plans = [tfu.build_stack_plan(HW, layers, 2, 2, [Group(0, 3), Group(4, 7)], **kw)
             for kw in (dict(), dict(schedule="overlap"), dict(crossover=4),
                        dict(crossover=4, schedule="overlap"))]
    keys = {plan_cache_key(p.inference_twin(), 4) for p in plans}
    assert len(keys) == len(plans)


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["sync", "overlap"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("crossover", CROSSOVERS)
def test_hybrid_loss_and_grads_match_jax_reference_loss(crossover, backend, schedule):
    params = _np_params(NARROW_YOLO)
    x, t = _data(NARROW_YOLO)
    jplan = jfu.build_stack_plan(HW, NARROW_YOLO, 1, 1)
    ref, ref_g = jax.value_and_grad(lambda p: jfu.reference_loss(p, x, t, jplan, jax_l2))(params)
    plan = tfu.build_stack_plan(HW, _port(NARROW_YOLO), 2, 2, backend=backend, schedule=schedule,
                                crossover=crossover)
    assert plan.crossover == crossover
    tp = [{k: v.requires_grad_(True) for k, v in p.items()} for p in params_from_jax(params, "cpu")]
    loss = tfu.make_tiled_loss(plan, make_tile_mesh(2, 2, "cpu"), l2_loss_local)(tp, x, t)
    assert abs(loss.item() - float(ref)) <= LOSS_RTOL * abs(float(ref))
    g = iter(torch.autograd.grad(loss, _leaves(tp)))
    for p, w in zip(tp, ref_g):
        for k in p:
            np.testing.assert_allclose(next(g).numpy(), np.asarray(w[k]), atol=GRAD_ATOL,
                                       err_msg=k)


def test_hybrid_deferred_step_equals_the_loss_on_the_whole_batch():
    """The microbatched deferred step on a hybrid plan == the gradient of
    ``make_tiled_loss`` on the concatenated batch (tests/test_hybrid.py:190):
    the adjoint reshard runs inside each microbatch."""
    params = params_from_jax(_np_params(DEFERRED_LAYERS), "cpu")
    plan = tfu.build_stack_plan(HW, _port(DEFERRED_LAYERS), 2, 2, backend="cuda", crossover=2)
    mesh = make_tile_mesh(2, 2, "cpu")
    xs, ts = _data(DEFERRED_LAYERS, lead=(2,))
    loss_d, grads_d = tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=2)(
        params, xs, ts)
    tp = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in params]
    loss_r = tfu.make_tiled_loss(plan, mesh, l2_loss_local)(
        tp, xs.reshape(8, *xs.shape[2:]), ts.reshape(8, *ts.shape[2:]))
    assert float(loss_d) == pytest.approx(loss_r.item(), rel=1e-5)
    for a, b in zip(_leaves(grads_d), torch.autograd.grad(loss_r, _leaves(tp))):
        assert float((a - b).abs().max()) < GRAD_ATOL


_JAX_HYBRID_2X2 = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from repro.core.fusion import (build_stack_plan, make_deferred_grad_step,
                                   make_tiled_forward)
    from repro.core.spatial import LayerDef
    from repro.core.tiling import Group
    from repro.launch.mesh import make_tile_mesh
    from repro.models.yolo import l2_loss_local
    FWD, STEP = %r, %r
    d = dict(np.load(sys.argv[1]))
    out = {}
    mesh = make_tile_mesh(2, 2)
    for name, (layers, groups, kw) in FWD.items():
        layers = [LayerDef(**l) for l in layers]
        g = None if groups is None else [Group(*gr) for gr in groups]
        plan = build_stack_plan(tuple(d["hw"]), layers, 2, 2, g, **kw)
        params = [{k: d[f"{name}/p{i}_{k}"] for k in ("w", "b", "bn_scale", "bn_bias")
                   if f"{name}/p{i}_{k}" in d} for i in range(len(layers))]
        out[f"{name}/y"] = np.asarray(jax.jit(make_tiled_forward(plan, mesh))(params, d["x"]))
    layers, kw = STEP
    layers = [LayerDef(**l) for l in layers]
    plan = build_stack_plan(tuple(d["hw"]), layers, 2, 2, **kw)
    params = [{k: d[f"step/p{i}_{k}"] for k in ("w", "b") if f"step/p{i}_{k}" in d}
              for i in range(len(layers))]
    step = make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=2)
    loss, grads = jax.jit(step)(params, d["xs"], d["ts"])
    out["step/loss"] = np.asarray(loss)
    for i, gr in enumerate(grads):
        for k, v in gr.items():
            out[f"step/g{i}_{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")
FWD_CASES = {
    "crossover-0-xla": (NARROW_YOLO, None, dict(crossover=0)),
    "crossover-4-pallas": (NARROW_YOLO[:6], None, dict(crossover=4, backend="pallas")),
    "crossover-4-overlap-xla": (NARROW_YOLO, [(0, 3), (4, 7)],
                                dict(crossover=4, schedule="overlap")),
    "crossover-last-xla": (NARROW_YOLO, None, dict(crossover=7)),
}


@pytest.fixture(scope="module")
def jax_hybrid(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid")
    x, _ = _data(NARROW_YOLO, b=8, seed=5)
    xs, ts = _data(DEFERRED_LAYERS, lead=(2,), seed=6)
    inputs = {"hw": np.array(HW), "x": x, "xs": xs, "ts": ts}
    for name, (layers, _, _) in FWD_CASES.items():
        for i, p in enumerate(_np_params(layers, seed=2)):
            for k, v in p.items():
                inputs[f"{name}/p{i}_{k}"] = v
    for i, p in enumerate(_np_params(DEFERRED_LAYERS, seed=3)):
        for k, v in p.items():
            inputs[f"step/p{i}_{k}"] = v
    np.savez(tmp / "in.npz", **inputs)
    fwd = {name: ([dataclasses.asdict(l) for l in layers], groups, kw)
           for name, (layers, groups, kw) in FWD_CASES.items()}
    step = ([dataclasses.asdict(l) for l in DEFERRED_LAYERS], dict(crossover=2))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", _JAX_HYBRID_2X2 % (fwd, step), str(tmp / "in.npz"),
                    str(tmp / "out.npz")], env=env, check=True, timeout=600)
    return inputs, dict(np.load(tmp / "out.npz"))


def _params_of(d, prefix, n_layers):
    out = [{} for _ in range(n_layers)]
    for key, v in d.items():
        if key.startswith(prefix):
            i, k = key[len(prefix):].split("_", 1)
            out[int(i)][k] = v
    return params_from_jax(out, "cpu")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_hybrid_forward_matches_the_references_2x2_forward(jax_hybrid, case, backend):
    """A hybrid plan's output leaves the executor in batch blocks (tile
    (i, j) holds block i*m + j); reassembled, it equals the reference's 2x2
    ``make_tiled_forward`` element by element - a wrong block order would
    show here even where a summed loss hides it."""
    inputs, out = jax_hybrid
    layers, groups, kw = FWD_CASES[case]
    kw = {k: v for k, v in kw.items() if k != "backend"}
    plan = tfu.build_stack_plan(HW, _port(layers), 2, 2, _groups(groups, Group),
                                backend=backend, **kw)
    params = _params_of(inputs, f"{case}/p", len(layers))
    got = tfu.make_tiled_forward(plan, make_tile_mesh(2, 2, "cpu"))(params, inputs["x"])
    want = out[f"{case}/y"]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=FWD_ATOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_hybrid_deferred_step_matches_the_references_2x2_step(jax_hybrid, backend):
    inputs, out = jax_hybrid
    plan = tfu.build_stack_plan(HW, _port(DEFERRED_LAYERS), 2, 2, backend=backend, crossover=2)
    params = _params_of(inputs, "step/p", len(DEFERRED_LAYERS))
    loss, grads = tfu.make_deferred_grad_step(plan, make_tile_mesh(2, 2, "cpu"), l2_loss_local,
                                              microbatches=2)(params, inputs["xs"], inputs["ts"])
    assert abs(float(loss) - float(out["step/loss"])) <= LOSS_RTOL * abs(float(out["step/loss"]))
    want = _params_of(out, "step/g", len(DEFERRED_LAYERS))
    for g, w in zip(grads, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k].numpy(), atol=GRAD_ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# named errors, serving
# ---------------------------------------------------------------------------


def test_microbatch_that_cannot_spread_over_the_tiles_is_named():
    plan = tfu.build_stack_plan(HW, _port(DEFERRED_LAYERS), 2, 2, crossover=2)
    mesh = make_tile_mesh(2, 2, "cpu")
    params = params_from_jax(_np_params(DEFERRED_LAYERS), "cpu")
    xs, ts = _data(DEFERRED_LAYERS, b=2, lead=(2,))
    msg = r"per-microbatch batch \(2\) divisible by the tile count \(2x2=4\)"
    with pytest.raises(ValueError, match=msg):
        tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=2)(params, xs, ts)
    with pytest.raises(ValueError, match=msg):
        tfu.make_tiled_loss(plan, mesh, l2_loss_local)(params, xs[0], ts[0])
    with pytest.raises(ValueError, match=msg):
        tfu.make_tiled_forward(plan, mesh)(params, xs[0])
    with pytest.raises(ValueError, match="divisible by the tile count"):
        tsp.reshard_spatial_to_data(torch.zeros(2, 2, 2, 4, 4, 1))


def test_serve_engine_buckets_must_spread_over_the_tiles():
    """A hybrid serve plan refuses buckets the tile count does not divide;
    with (4, 8) it serves, each response the untiled frozen-BN forward."""
    layers = _port(NARROW_YOLO)
    plan = tfu.build_stack_plan(HW, layers, 2, 2, [Group(0, 3), Group(4, 7)], backend="cuda",
                                crossover=4, schedule="overlap", inference=True)
    mesh = make_tile_mesh(2, 2, "cpu")
    params = tsp.init_stack_params(torch.Generator().manual_seed(0), layers)
    rng = np.random.default_rng(4)
    frozen = tsp.freeze_bn_stats(params, layers, torch.from_numpy(
        rng.standard_normal((4, *HW, 3)).astype(np.float32)))
    with pytest.raises(ValueError, match=r"buckets \[1, 2\] not divisible by the tile count"):
        CNNServeEngine(plan, mesh, frozen, buckets=(1, 2, 4, 8), step_bound=0.01)
    clock = ManualClock()
    eng = CNNServeEngine(plan, mesh, frozen, buckets=(4, 8), step_bound=0.01,
                         latency_budget=1.0, clock=clock, simulate_step_s=0.01)
    images = rng.standard_normal((11, *HW, 3)).astype(np.float32)
    for im in images:
        eng.submit(im)
    eng.drain()
    assert [b["bucket"] for b in eng.batch_log] == [8, 4]
    got = np.stack([r.result for r in sorted(eng.finished, key=lambda r: r.rid)])
    want = tfu.reference_forward(frozen, torch.from_numpy(images), plan).numpy()
    np.testing.assert_allclose(got, want, atol=FWD_ATOL)


def test_launchers_plan_and_run_hybrid_and_overlap_on_cpu(capsys):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    base = ["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "64", "--depth", "8",
            "--grid", "2", "--steps", "1", "--batch", "8", "--grad-accum", "2", "--optimizer",
            "sgd"]
    assert train_main(base + ["--groups", "auto", "--crossover", "auto", "--hw-profile",
                              "tpu-v5e-chip", "--schedule", "overlap"]) == 0
    out = capsys.readouterr().out
    jp = jfu.build_stack_plan((64, 64), jax_yolo_layers()[:8], 2, 2, "auto", hw="tpu-v5e-chip",
                              batch=8, crossover="auto", schedule="overlap", microbatches=2)
    assert jp.crossover == 0          # at this size the cost model keeps no spatial prefix
    assert (f"schedule=overlap grid=2x2 crossover={jp.crossover} "
            f"groups={[(g.start, g.end, g.mode) for g in jp.groups]}") in out
    assert "done: steps=1 restarts=0" in out
    with pytest.raises(ValueError, match="divisible by the tile count"):
        train_main(base[:-6] + ["--batch", "4", "--grad-accum", "2", "--crossover", "2"])
    assert serve_main(["--cnn", "--device", "cpu", "--size", "32", "--depth", "4", "--schedule",
                       "overlap", "--crossover", "2", "--buckets", "4", "8", "--requests", "8",
                       "--ticks", "2"]) == 0
    out = capsys.readouterr().out
    assert "plan: schedule=overlap crossover=2 modes=['spatial', 'spatial', 'data', 'data']" in out
    assert "served 8 requests" in out
