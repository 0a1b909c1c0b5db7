"""The tiled CNN's serve engine on ranks (``serve/cnn_engine.py`` on a
``launch/mesh.py:DistTileMesh``) against the virtual-mesh engine, the
untiled reference and the JAX reference's engine on a 2x2 fake-device mesh.

The slice: YOLOv2's first 4 layers at 32x32 on a 2x2 grid, groups
(0-1)(2-3) (the cluster plan: the cost model's), frozen BN, ``REQUESTS``
images arriving over ``ARRIVALS`` ticks of a ``ManualClock`` (``TICK_S`` a
tick, ``SERVICE_S`` a dispatch), four plans: sync, overlap, a crossover to
a data-mode tail (buckets divisible by the 4 tiles), and the
``pi3x3+jetson`` cluster's ragged spec partition.  Rank 0 owns the queue and
broadcasts each dispatch's header and batch; the other ranks follow.  CPU
ranks run gloo, one intra-op thread each (``run_ranks``):

- W = 1: the responses and the batch log bitwise the virtual-mesh engine's
  (in the same process);
- W = 2 and W = 4: the responses within the serve bar (``SERVE_BAR``) of
  the untiled reference, the batch log the virtual engine's, the followers
  serving every dispatch;
- every rank's collectives per dispatch (each kind's count and bytes) equal
  ``analysis/collectives.py:plan_collectives(forward_only=True)`` at its
  place plus ``dispatch_collectives``, and its BN statistics rank 0's;
- a planted fault - one follower serving the batch its bucket held at its
  previous dispatch (it still takes part in every broadcast) - fails the
  bar and does not hang;
- ``launch/serve.py --cnn --dist`` under ``torch.distributed.run`` prints
  one plan line, with ``dist=2``;
- the JAX reference's engine (a subprocess with 4 fake devices, started
  first; it writes its params, calibration batch and images before it
  compiles, so the ranks run meanwhile) gives the same batch log, and
  responses within the bar.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.analysis.collectives import (
    collective_stats,
    dispatch_collectives,
    plan_collectives,
    split_record,
)
from repro_torch.core import fusion as tfu
from repro_torch.core import spatial as tsp
from repro_torch.core.tiling import Group
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_dist_tile_mesh, make_tile_mesh
from repro_torch.models.tiled_cnn import TiledCNNArch
from repro_torch.models.yolo import yolov2_16_layers
from repro_torch.parallel.dist import run_ranks
from repro_torch.serve.cnn_engine import CNNServeEngine, ManualClock

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 32)
DEPTH = 4
LAYERS = yolov2_16_layers()[:DEPTH]
GROUPS = [(0, 1), (2, 3)]
ARRIVALS = (3, 1, 0, 5, 2, 0, 1, 4, 0, 2)
REQUESTS = sum(ARRIVALS)
TICK_S, SERVICE_S, STEP_BOUND_S, BUDGET_S = 0.01, 0.004, 0.01, 0.035
SERVE_BAR = dict(atol=1e-4, rtol=1e-4)        # chip_smoke.py's TOL_SERVE
# name: (build_stack_plan kwargs, bucket ladder)
PLANS = {
    "sync": ({}, (1, 2, 4)),
    "overlap": ({"schedule": "overlap"}, (1, 2, 4)),
    "hybrid": ({"crossover": 2}, (4, 8)),
    "cluster_spec": ({"groups": "auto", "hw": "pi3x3+jetson", "batch": 4}, (1, 2, 4)),
}

# The reference's engines, one process with 4 fake devices: the inputs and
# the unfrozen params go to ``sys.argv[2]`` first (written whole, then
# renamed), then each plan's engine serves the images under the same clock
# (its executables compile on first use: one a bucket dispatched).
_JAX_ENGINES = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.core.fusion import build_stack_plan
    from repro.core.spatial import freeze_bn_stats, init_stack_params
    from repro.core.tiling import Group
    from repro.launch.mesh import make_tile_mesh
    from repro.models.yolo import yolov2_16_layers
    from repro.serve.cnn_engine import CNNServeEngine, ManualClock
    plans, arrivals, (tick, service, bound, budget) = json.loads(sys.argv[3])
    layers = yolov2_16_layers()[:4]
    rng = np.random.default_rng(0)
    params = init_stack_params(jax.random.PRNGKey(0), layers)
    calib = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    images = rng.standard_normal((sum(arrivals), 32, 32, 3)).astype(np.float32)
    out = {"calib": calib, "images": images}
    for i, p in enumerate(params):
        for k, v in p.items():
            out[f"p{i}_{k}"] = np.asarray(v)
    with open(sys.argv[2] + ".part", "wb") as f:
        np.savez(f, **out)
    os.replace(sys.argv[2] + ".part", sys.argv[2])
    frozen = freeze_bn_stats(params, layers, calib)
    mesh = make_tile_mesh(2, 2)
    res = {}
    for name, (kw, buckets) in plans.items():
        kw = dict(kw)
        groups = kw.pop("groups", [Group(0, 1), Group(2, 3)])
        plan = build_stack_plan((32, 32), layers, 2, 2, groups, inference=True, **kw)
        eng = CNNServeEngine(plan, mesh, frozen, buckets=buckets, step_bound=bound,
                             latency_budget=budget, clock=ManualClock(),
                             simulate_step_s=service)
        it = iter(images)
        for a in arrivals:
            for _ in range(a):
                eng.submit(next(it))
            eng.clock.advance(tick)
            eng.step()
        eng.drain()
        res[name] = np.stack([r.result for r in sorted(eng.finished, key=lambda r: r.rid)])
        res[name + "_log"] = np.array([[b["t"], b["bucket"], b["filled"]] for b in eng.batch_log])
    np.savez(sys.argv[1], **res)
""")


@pytest.fixture(scope="module", autouse=True)
def jax_started(tmp_path_factory):
    import json

    path = tmp_path_factory.mktemp("jaxserve") / "engines.npz"
    init = path.with_name("init.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    spec = json.dumps([{k: [kw, list(b)] for k, (kw, b) in PLANS.items()}, list(ARRIVALS),
                       [TICK_S, SERVICE_S, STEP_BOUND_S, BUDGET_S]])
    proc = subprocess.Popen([sys.executable, "-c", _JAX_ENGINES, str(path), str(init), spec],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, path, init
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _init_path(started) -> str:
    proc, _, init = started
    deadline = time.monotonic() + 600
    while not init.exists():
        if proc.poll() is not None:
            assert init.exists(), proc.communicate()[0]
        assert time.monotonic() < deadline, "the reference wrote no inputs"
        time.sleep(0.05)
    return str(init)


def _inputs(path):
    d = np.load(path)
    params = [{} for _ in range(DEPTH)]
    for key in d.files:
        if key.startswith("p") and key[1].isdigit():
            i, k = key[1:].split("_", 1)
            params[int(i)][k] = d[key]
    return params_from_jax(params, "cpu"), d["calib"], d["images"]


def _plan(name):
    kw = dict(PLANS[name][0])
    groups = kw.pop("groups", [Group(*g) for g in GROUPS])
    return tfu.build_stack_plan(HW, LAYERS, 2, 2, groups, **kw)


def _drive(engine, images) -> tuple[np.ndarray, list]:
    """The clock's ticks: each tick's arrivals, the clock on, one engine
    step; then the drain.  -> responses in request order, the batch log as
    (t, bucket, filled)."""
    it = iter(images)
    for a in ARRIVALS:
        for _ in range(a):
            engine.submit(next(it))
        engine.clock.advance(TICK_S)
        engine.step()
    engine.drain()
    res = np.stack([r.result for r in sorted(engine.finished, key=lambda r: r.rid)])
    return res, [(b["t"], b["bucket"], b["filled"]) for b in engine.batch_log]


def _engine(arch, params, calib, name):
    return arch.make_serve_engine(params, calibration=calib, buckets=PLANS[name][1],
                                  step_bound=STEP_BOUND_S, latency_budget=BUDGET_S,
                                  clock=ManualClock(), simulate_step_s=SERVICE_S)


def _serve_rank(group, init, fault: bool) -> dict:
    """Every plan's engine on this rank's block: rank 0 drives the clock and
    the queue, the others follow.  Per plan: rank 0's responses and batch
    log, every rank's record of the drive (after the warm ladder), its
    place, the dispatches it followed and its frozen BN statistics.  At
    W = 1 also the virtual-mesh engine's responses and log, in this
    process.  ``fault``: the sync plan again with the last rank serving a
    stale batch."""
    torch.set_num_threads(1)
    params, calib, images = _inputs(init)
    out = {}
    runs = list(PLANS) + (["fault"] if fault else [])
    for name in runs:
        plan = _plan("sync" if name == "fault" else name)
        mesh = make_dist_tile_mesh(2, 2, "cpu", group)
        arch = TiledCNNArch(plan=plan, mesh=mesh)
        real = CNNServeEngine._share_batch
        if name == "fault" and group.rank == group.world - 1:
            # the planted follower takes part in the batch's broadcast but
            # keeps what its bucket's input held at its previous dispatch
            CNNServeEngine._share_batch = lambda self, x: real(self, x.clone())
        try:
            engine = _engine(arch, params, calib, "sync" if name == "fault" else name)
            engine.warmup()
            group.take_record()
            row = {"coord": mesh.coord, "ranks": mesh.ranks,
                   "bn": [p["bn_var"].clone() for p in engine.params if "bn_var" in p]}
            if engine.leader:
                try:
                    row["res"], row["log"] = _drive(engine, images)
                finally:
                    engine.finish()
            else:
                row["followed"] = engine.follow()
            row["record"] = group.take_record()
        finally:
            CNNServeEngine._share_batch = real
        if group.world == 1 and name != "fault":
            virtual = TiledCNNArch(plan=plan, mesh=make_tile_mesh(2, 2, "cpu"))
            row["virtual"] = _drive(_engine(virtual, params, calib, name), images)
        out[name] = row
    return out


@pytest.fixture(scope="module")
def rank_runs(jax_started):
    init = _init_path(jax_started)
    return {w: run_ranks(_serve_rank, w, "cpu", args=(init, w == 4), timeout=300)
            for w in (1, 2, 4)}


@pytest.fixture(scope="module")
def untiled(jax_started):
    params, calib, images = _inputs(_init_path(jax_started))
    frozen = tsp.freeze_bn_stats(params, LAYERS, torch.from_numpy(calib))
    with torch.no_grad():
        return tsp.stack_reference(torch.from_numpy(images), frozen, LAYERS,
                                   inference=True).numpy()


@pytest.fixture(scope="module")
def jax_engines(jax_started, rank_runs):
    proc, path, _ = jax_started
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    return np.load(path)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_one_rank_is_the_virtual_engine_bitwise(name, rank_runs):
    (row,) = rank_runs[1]
    run = row[name]
    res, log = run["virtual"]
    assert run["log"] == log
    assert np.array_equal(run["res"], res)
    assert len(set(b for _, b, _ in log)) >= 2          # the drive dispatches two buckets


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranks_serve_within_the_bar(name, world, rank_runs, untiled):
    rows = rank_runs[world]
    lead = rows[0][name]
    np.testing.assert_allclose(lead["res"], untiled, **SERVE_BAR)
    assert lead["log"] == rank_runs[1][0][name]["virtual"][1]
    for r in rows[1:]:
        assert r[name]["followed"] == len(lead["log"])
        for a, b in zip(r[name]["bn"], lead["bn"]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_each_ranks_collectives_per_dispatch_are_the_model(name, world, rank_runs):
    """A rank's record of the drive: the forward of each dispatch at its
    bucket (``plan_collectives(forward_only=True)`` at the rank's place)
    and rank 0's header and batch broadcasts, with the stop."""
    rows = rank_runs[world]
    log = rows[0][name]["log"]
    plan = _plan(name).inference_twin()
    image_bytes = 4 * HW[0] * HW[1] * 3
    for row in (r[name] for r in rows):
        steps, roles = split_record(row["record"])
        st = collective_stats(steps)
        got = {k: [st.count[k], st.bytes_naive[k]] for k in st.count}
        want: dict = {}
        for _, bucket, _ in log:
            for k, (c, b) in plan_collectives(plan, bucket, row["ranks"], row["coord"],
                                              forward_only=True).items():
                w = want.setdefault(k, [0, 0])
                w[0], w[1] = w[0] + c, w[1] + b
        assert got == want
        assert roles == dispatch_collectives([b for _, b, _ in log], image_bytes)


def test_a_follower_serving_a_stale_batch_fails_the_bar(rank_runs, untiled):
    rows = rank_runs[4]
    got = rows[0]["fault"]["res"]
    assert rows[0]["fault"]["log"] == rows[0]["sync"]["log"]
    assert not np.allclose(got, untiled, **SERVE_BAR)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_the_jax_engine_gives_the_same_log_and_responses_within_the_bar(name, jax_engines,
                                                                         rank_runs):
    lead = rank_runs[4][0][name]
    log = jax_engines[name + "_log"]
    assert [(float(t), int(b), int(f)) for t, b, f in log] == lead["log"]
    np.testing.assert_allclose(lead["res"], jax_engines[name], **SERVE_BAR)


def test_the_serve_launcher_on_two_ranks_prints_one_plan_line():
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --cnn
    --dist --device cpu``: rank 0 serves and prints, rank 1 follows."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", "--cnn",
                          "--device", "cpu", "--size", "32", "--depth", "4", "--requests", "8",
                          "--ticks", "4", "--dist", "--dist-backend", "gloo"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    lines = run.stdout.splitlines()
    plan = [ln for ln in lines if ln.startswith("plan: schedule")]
    assert len(plan) == 1 and "dist=2 ranks=2x1 backend=gloo captured=False" in plan[0]
    assert "warmup: eager step on cpu (no capture; eager: cpu)" in run.stdout
    assert any(ln.startswith("served 8 requests") for ln in lines)


def test_the_serve_launcher_refuses_the_lm_on_ranks():
    from repro_torch.launch.serve import main

    with pytest.raises(ValueError, match="A.20.5"):
        main(["--dist", "--device", "cpu"])
