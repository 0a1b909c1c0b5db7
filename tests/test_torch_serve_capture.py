"""The serve engine's staging and param binding, the CPU side of the
captured serve step (``serve/exec_cache.py:CapturedStep``), against the
reference's serve semantics.

- a CPU mesh serves through the eager step; ``capture=True`` there raises,
  and so does a capture on a CPU device;
- engine responses of a sync, an overlap, a hybrid, a ragged spec, a ragged
  padded, an int8 and a top-k plan (YOLOv2's first 4 layers at 32 px on
  2x2) equal
  ``make_tiled_infer`` on the batches as dispatched, bit for bit, and the
  JAX reference engine's (a subprocess with 4 fake devices) at
  ``tests/test_torch_serve.py``'s atol=1e-5;
- a response is a copy: the next dispatch on the same bucket, through the
  same reused staging buffers, leaves it alone; a partial batch's padding
  rows are zero;
- ``ParamBinder`` sees a swapped leaf and an in-place update (``_version``)
  and copies nothing otherwise;
- after a warm forward a second one makes no new ``plan_constant`` (a
  fresh host copy, which a CUDA-graph capture refuses) and leaves a codec
  plan's stateless wire context as it was, for every plan kind above;
- ``ExecutableCache.misses`` equals the ladder after ``warmup`` and stays
  flat through ``run_serving``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import fusion as tfu
from repro_torch.core import spatial as tsp
from repro_torch.core.tiling import TilePartition
from repro_torch.interop import params_from_jax
from repro_torch.kernels.conv2d_tiled.kernel import FWD_TILES, launch_counts
from repro_torch.launch.mesh import make_tile_mesh, plan_constant
from repro_torch.models.yolo import yolov2_16_layers
from repro_torch.runtime.driver import run_serving
from repro_torch.serve.cnn_engine import CNNServeEngine, ManualClock
from repro_torch.serve.exec_cache import CapturedStep, ParamBinder

ATOL = 1e-5                     # tests/test_torch_serve.py
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 32)
DEPTH = 4
N_IMAGES = 5
PARTITION = ((0, 24, 32), (0, 16, 32))
# name: (build_stack_plan kwargs, bucket ladder)
PLANS = {
    "sync": ({}, (1, 4)),
    "overlap": ({"schedule": "overlap"}, (1, 4)),
    "hybrid": ({"crossover": 2}, (4, 8)),
    "spec": ({"partition": PARTITION, "ragged_exec": "spec"}, (1, 4)),
    "padded": ({"partition": PARTITION, "ragged_exec": "padded"}, (1, 4)),
    "int8": ({"wire_codec": "int8"}, (1, 4)),
    "topk": ({"wire_codec": "topk:0.5"}, (1, 4)),
}

# The reference engine serves the same images with the same params under each
# plan (ManualClock, drained, so both engines dispatch the same batches).
_JAX_ENGINES = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.core.fusion import build_stack_plan
    from repro.core.spatial import freeze_bn_stats, init_stack_params
    from repro.core.tiling import TilePartition
    from repro.launch.mesh import make_tile_mesh
    from repro.models.yolo import yolov2_16_layers
    from repro.serve.cnn_engine import CNNServeEngine, ManualClock
    plans = %r
    layers = yolov2_16_layers()[:%d]
    rng = np.random.default_rng(0)
    params = init_stack_params(jax.random.PRNGKey(0), layers)
    params = freeze_bn_stats(params, layers, rng.standard_normal((4, %d, %d, 3)).astype(np.float32))
    images = rng.standard_normal((%d, %d, %d, 3)).astype(np.float32)
    out = {"images": images}
    for i, p in enumerate(params):
        for k, v in p.items():
            out[f"p{i}_{k}"] = np.asarray(v)
    mesh = make_tile_mesh(2, 2)
    for name, (kw, buckets) in plans.items():
        kw = dict(kw)
        if "partition" in kw:
            kw["partition"] = TilePartition(*kw["partition"])
        plan = build_stack_plan(images.shape[1:3], layers, 2, 2, inference=True, **kw)
        eng = CNNServeEngine(plan, mesh, params, buckets=buckets, step_bound=0.01,
                             latency_budget=1.0, clock=ManualClock())
        for im in images:
            eng.submit(im)
        eng.drain()
        out[name] = np.stack([r.result for r in sorted(eng.finished, key=lambda r: r.rid)])
        out[name + "_log"] = np.array([[b["bucket"], b["filled"]] for b in eng.batch_log])
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jax_engines(tmp_path_factory):
    out = tmp_path_factory.mktemp("capture") / "engines.npz"
    script = _JAX_ENGINES % ({k: v for k, v in PLANS.items()}, DEPTH, *HW, N_IMAGES, *HW)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", script, str(out)], env=env, check=True, timeout=900)
    d = np.load(out)
    params = [{} for _ in range(DEPTH)]
    for key in d.files:
        if key.startswith("p") and "_" in key and key[1].isdigit():
            i, k = key[1:].split("_", 1)
            params[int(i)][k] = d[key]
    return d, params_from_jax(params, "cpu")


def _plan(name, **extra):
    kw = dict(PLANS[name][0], **extra)
    if "partition" in kw:
        kw["partition"] = TilePartition(*kw["partition"])
    return tfu.build_stack_plan(HW, yolov2_16_layers()[:DEPTH], 2, 2, inference=True, **kw)


def _setup(name="sync", seed=0):
    layers = yolov2_16_layers()[:DEPTH]
    rng = np.random.default_rng(seed)
    params = tsp.init_stack_params(torch.Generator().manual_seed(seed), layers)
    frozen = tsp.freeze_bn_stats(params, layers, torch.from_numpy(
        rng.standard_normal((4, *HW, 3)).astype(np.float32)))
    images = rng.standard_normal((8, *HW, 3)).astype(np.float32)
    return _plan(name), make_tile_mesh(2, 2, "cpu"), frozen, images


def _engine(plan, mesh, params, buckets, **kw):
    return CNNServeEngine(plan, mesh, params, buckets=buckets, step_bound=0.01,
                          latency_budget=1.0, clock=ManualClock(), **kw)


def _dispatched(engine, images, infer, params):
    """The forward of each batch the engine dispatched (zero-padded to its
    bucket), rows in request order."""
    rows, i = [], 0
    for b in engine.batch_log:
        x = np.zeros((b["bucket"], *images.shape[1:]), np.float32)
        x[:b["filled"]] = images[i:i + b["filled"]]
        rows.append(infer(params, torch.from_numpy(x)).numpy()[:b["filled"]])
        i += b["filled"]
    return np.concatenate(rows)


def test_capture_is_refused_on_the_cpu_and_the_default_is_eager():
    plan, mesh, params, images = _setup()
    with pytest.raises(ValueError, match="capture=True needs a CUDA mesh"):
        _engine(plan, mesh, params, (1, 2), capture=True)
    for capture in (None, False):
        engine = _engine(plan, mesh, params, (1, 2), capture=capture)
        assert engine.capture is False
        engine.warmup()
        assert engine.stats()["capture"] == {"buckets": [], "replays": {}, "pool_bytes": {},
                                             "launches": {}}
    with pytest.raises(ValueError, match="needs a CUDA device"):
        CapturedStep(tfu.make_tiled_infer(plan, mesh), params, (1, *HW, 3),
                     dtype=torch.float32, device="cpu", counters=launch_counts)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_engine_responses_equal_the_forward_and_the_reference_engine(name, jax_engines):
    d, params = jax_engines
    plan, buckets = _plan(name), PLANS[name][1]
    mesh = make_tile_mesh(2, 2, "cpu")
    engine = _engine(plan, mesh, params, buckets)
    images = d["images"]
    for im in images:
        engine.submit(im)
    engine.drain()
    got = np.stack([r.result for r in sorted(engine.finished, key=lambda r: r.rid)])
    assert [[b["bucket"], b["filled"]] for b in engine.batch_log] == d[name + "_log"].tolist()
    np.testing.assert_array_equal(got, _dispatched(engine, images, tfu.make_tiled_infer(plan, mesh),
                                                   params))
    np.testing.assert_allclose(got, d[name], atol=ATOL)


def test_a_response_survives_the_next_dispatch_on_its_bucket():
    plan, mesh, params, images = _setup()
    engine = _engine(plan, mesh, params, (2,))
    first = [engine.submit(im) for im in images[:2]]
    engine.drain()
    kept = [r.result.copy() for r in first]
    for im in images[2:4]:
        engine.submit(im)
    engine.drain()
    assert [b["bucket"] for b in engine.batch_log] == [2, 2]
    out = engine._staging(2)[1].numpy()
    for r, k in zip(first, kept):
        np.testing.assert_array_equal(r.result, k)
        assert not np.shares_memory(r.result, out)
    assert not np.array_equal(first[0].result, engine.finished[2].result)


def test_a_partial_batch_pads_the_reused_staging_buffer_with_zeros():
    """The int8 plan quantises each tile's strip over the whole batch, so a
    stale row left in the staging buffer would move the real row's result."""
    plan, mesh, params, images = _setup("int8")
    engine = _engine(plan, mesh, params, (4,))
    seen = []
    prepare = engine._prepare

    def spy_prepare(bucket):
        step = prepare(bucket)

        def spy(p, x):
            seen.append((x.data_ptr(), x.clone()))
            return step(p, x)

        return spy

    engine._prepare = spy_prepare
    for im in images[:4]:
        engine.submit(im)
    engine.drain()
    partial = engine.submit(images[4])
    engine.drain()
    assert [(b["bucket"], b["filled"]) for b in engine.batch_log] == [(4, 4), (4, 1)]
    (ptr0, x0), (ptr1, x1) = seen
    assert ptr0 == ptr1                               # one reused buffer
    np.testing.assert_array_equal(x0.numpy(), images[:4])
    np.testing.assert_array_equal(x1[0].numpy(), images[4])
    assert not x1[1:].any()
    want = np.zeros((4, *HW, 3), np.float32)
    want[0] = images[4]
    np.testing.assert_array_equal(
        partial.result, tfu.make_tiled_infer(plan, mesh)(params, torch.from_numpy(want))[0].numpy())


def test_param_binder_sees_a_swapped_leaf_and_an_in_place_update():
    _, _, params, _ = _setup()
    binder = ParamBinder(params)
    static = binder.static
    assert static[0]["w"] is not params[0]["w"] and torch.equal(static[0]["w"], params[0]["w"])
    assert binder.bind(params) is False and binder.copies == 0
    # a swapped leaf: another tensor in the caller's tree
    swapped = [dict(p) for p in params]
    swapped[2]["w"] = params[2]["w"] * 2
    assert binder.bind(swapped) is True and binder.copies == 1
    assert torch.equal(static[2]["w"], swapped[2]["w"])
    assert binder.bind(swapped) is False
    # an in-place update of a leaf it bound bumps its version
    with torch.no_grad():
        swapped[0]["w"].add_(1.0)
    assert binder.bind(swapped) is True and torch.equal(static[0]["w"], swapped[0]["w"])
    assert binder.bind(swapped) is False and binder.copies == 2
    # the static tensors stay the ones a graph captured: copied into, never replaced
    assert binder.static is static
    # inference tensors track no version: copied every time
    with torch.inference_mode():
        inf = [{k: v.clone() for k, v in p.items()} for p in swapped]
    assert binder.bind(inf) is True and binder.bind(inf) is True
    with pytest.raises(ValueError, match="structure"):
        binder.bind(swapped[:-1])
    bad = [dict(p) for p in swapped]
    bad[0]["w"] = bad[0]["w"][..., :1]
    with pytest.raises(ValueError, match="captured with"):
        binder.bind(bad)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_a_warm_forward_leaves_nothing_for_a_capture_to_make(name, monkeypatch):
    """Capture refuses a pageable host copy and repeats no host-side state:
    after one warm forward, the next makes no new plan constant, and a codec
    plan's stateless wire context draws and emits nothing."""
    wires = []
    real = tfu._stateless_wire
    monkeypatch.setattr(tfu, "_stateless_wire", lambda plan: wires.append(real(plan)) or wires[-1])
    plan, mesh, params, images = _setup(name)
    infer = tfu.make_tiled_infer(plan, mesh)
    b = PLANS[name][1][-1]
    x = torch.from_numpy(np.resize(images, (b, *images.shape[1:])))
    first = infer(params, x)
    misses = plan_constant.cache_info().misses
    assert torch.equal(infer(params, x), first)
    assert plan_constant.cache_info().misses == misses
    (wire,) = wires
    if name in ("int8", "topk"):
        bag = wire.bag
        assert bag.mode == "stateless" and not (bag.shapes or bag.drawn or bag.emitted)
    else:
        assert wire is None


def test_misses_equal_the_ladder_and_stay_flat_through_a_run(capsys):
    plan, mesh, params, images = _setup()
    buckets = (1, 2, 4)
    engine = _engine(plan, mesh, params, buckets, simulate_step_s=0.001)
    assert engine.warmup()["misses"] == len(buckets)
    it = iter(np.resize(images, (11, *images.shape[1:])))

    def on_tick(t, eng):
        for _ in range((3, 1, 4, 2, 1)[t]):
            eng.submit(next(it))

    report = run_serving(engine, ticks=5, on_tick=on_tick)
    assert report.served == 11 and report.cache["misses"] == len(buckets)
    assert report.cache["hits"] == report.dispatches
    assert report.capture == engine.stats()["capture"] and report.capture["buckets"] == []
    from repro_torch.launch.serve import main

    assert main(["--cnn", "--device", "cpu", "--size", "32", "--depth", "4", "--requests", "4",
                 "--ticks", "2", "--buckets", "1", "2"]) == 0
    out = capsys.readouterr().out
    assert "warmup: eager step on cpu (no capture)" in out
    assert 'capture: {"buckets": [], ' in out


def test_launch_counts_flatten_the_b1_counters():
    counts = launch_counts()
    assert set(counts) == {"conv2d_tile"} | {f"conv2d_tile/{k}" for k in FWD_TILES}
    assert counts["conv2d_tile"] == sum(v for k, v in counts.items() if "/" in k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(PLANS))
def test_captured_replay_equals_the_eager_forward_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode); run chip_smoke.py there")
    plan, _, params, images = _setup(name)
    dev = torch.device("cuda")
    mesh = make_tile_mesh(2, 2, dev)
    params = [{k: v.to(dev) for k, v in p.items()} for p in params]
    engine = CNNServeEngine(plan, mesh, params, buckets=PLANS[name][1], step_bound=0.01)
    assert engine.capture and engine.warmup()["misses"] == len(PLANS[name][1])
    infer = tfu.make_tiled_infer(plan, mesh)
    for b in engine.buckets:
        x = torch.from_numpy(np.resize(images, (b, *images.shape[1:]))).to(dev)
        assert torch.equal(engine.executable(b)(params, x), infer(params, x))
