"""The overlap schedule and a hybrid (spatial -> data) plan on ranks
(``launch/mesh.py:DistTileMesh`` over ``parallel/dist.py``) against the
virtual mesh and the JAX reference's ``shard_map`` on 4 fake devices.

The slice is the paper's training step on a 2x2 grid: YOLOv2's first 4
layers (BN, two pools) at 32x32, groups (0-1)(2-3), 2 microbatches of 4
images (a data-mode tail needs the microbatch divisible by the 4 tiles),
under two plans: ``schedule="overlap"`` (the packed swap of each 2-tile
axis, the interior conv issued while the row strips are on the wire) and
``crossover=2`` (the second group on batch blocks of full maps: two tiled
all-gathers, the reduce-scatter in the backward).  CPU ranks run gloo, one
intra-op thread each, one spawn of ranks per world size (``run_ranks``):

- W = 1 (the whole grid on one rank): the loss, the forward, the deferred
  gradients and the params after 2 SGD steps bitwise equal to the virtual
  mesh (``make_tile_mesh``) in the same process;
- W = 2 (blocks of two tiles: the rows swap across ranks, the columns
  flip locally) and W = 4 (one tile a rank): the same in fp64 within
  ``FP64_BAR`` of the virtual mesh, and at W = 4 in fp32 against the
  reference's 2x2 ``shard_map`` (backend "pallas", interpret mode) within
  ``tests/test_kernels.py:23``'s tolerances (grads: its ``:201``);
- W = 4: planted faults fail the fp64 bar - the swap's lo and hi halves
  exchanged, a tile index without its block's offset (the reference's
  ``axis_index`` is the grid's), a batch block taken from the next rank;
- W = 4: the collectives a rank records over the fp32 deferred step (count
  and bytes of ``collective-permute``, ``all-gather`` and the
  ``reduce-scatter``) equal the reference's per device in the same
  compiled step, times the microbatch loop's trip count, and
  ``analysis/collectives.py:plan_collectives``;
- on a rank the overlap lead's row strips are still on the wire when its
  interior conv is issued;
- the launcher under ``--dist`` takes a pipeline tail and a heterogeneous
  cluster, with checkpoints and faults too (ROADMAP A.20.2, elastic).

The wire codecs on ranks: ``tests/test_torch_dist_codecs.py``.
"""
import os
import re
import subprocess
import sys
import textwrap
import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.analysis.collectives import collective_stats, plan_collectives
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import fusion as tfu
from repro_torch.core import halo as thalo
from repro_torch.core import spatial as tsp
from repro_torch.core.tiling import Group
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_dist_tile_mesh, make_tile_mesh
from repro_torch.models.tiled_cnn import TiledCNNArch
from repro_torch.models.yolo import l2_loss_local, yolov2_16_layers
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.parallel import dist as tdist
from repro_torch.parallel.dist import run_ranks
from repro_torch.train.trainer import TrainState, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 32)
GROUPS = [(0, 1), (2, 3)]
LAYERS = yolov2_16_layers()[:4]
MICRO, MB = 2, 4                           # 2 microbatches of 4 images
STEPS = 2
TOL = dict(atol=2e-5, rtol=1e-4)           # tests/test_kernels.py:23, fp32
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)      # tests/test_kernels.py:201, fp32 grads
FP64_BAR = 1e-12                           # ranks vs the virtual mesh, fp64, x max(1, |ref|)
PLANS = {"overlap": dict(schedule="overlap"), "crossover": dict(crossover=2)}
FAULTS = {"swap_halves_exchanged": "overlap", "tile_index_unoffset": "overlap",
          "batch_block_of_the_next_rank": "crossover"}
KINDS = ("collective-permute", "all-gather", "reduce-scatter")

# The reference's plans, one process with 4 fake devices.  First the inputs
# and each plan's initial params go to ``sys.argv[3]`` (written whole, then
# renamed), so that the ranks start on them while the reference compiles.
# Then per plan the deferred step compiled once (its HLO's collectives,
# each times its loop's trip count) and that executable called, and one
# jitted call for the forward, the tiled loss and 2 steps of its trainer
# (a scan, so the step is traced once).  ``sys.argv[2]`` is the plans as
# JSON.
_JAX_REF = textwrap.dedent("""
    import json, os, re, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.analysis import hlo
    from repro.configs.base import ParallelConfig, TrainConfig
    from repro.core.fusion import (build_stack_plan, make_deferred_grad_step,
                                   make_tiled_forward, make_tiled_loss)
    from repro.core.tiling import Group
    from repro.launch.mesh import make_tile_mesh
    from repro.models.tiled_cnn import TiledCNNArch
    from repro.models.yolo import l2_loss_local, yolov2_16_layers
    from repro.train.trainer import make_train_step
    mesh = make_tile_mesh(2, 2)
    r = np.random.default_rng(9)
    xs = r.standard_normal((2, 4, 32, 32, 3)).astype(np.float32)
    ts = (0.05 * r.standard_normal((2, 4, 8, 8, 64))).astype(np.float32)
    batches = []
    for s in range(2):
        rr = np.random.default_rng([0, s])
        batches.append({"x": rr.standard_normal((8, 32, 32, 3), np.float32),
                        "t": 0.05 * rr.standard_normal((8, 8, 8, 64), np.float32)})
    stacked = jax.tree.map(lambda *v: np.stack(v), *batches)
    out, built = {"xs": xs, "ts": ts}, {}
    for name, kw in json.loads(sys.argv[2]).items():
        plan = build_stack_plan((32, 32), yolov2_16_layers()[:4], 2, 2,
                                [Group(0, 1), Group(2, 3)], backend="pallas", **kw)
        arch = TiledCNNArch(plan=plan, mesh=mesh, loss_local=l2_loss_local)
        init_state, step = make_train_step(arch, ParallelConfig(grad_accum=2),
                                           TrainConfig(lr=1e-3, optimizer="sgd", warmup=0,
                                                       steps=2))
        built[name] = plan, step, init_state(jax.random.PRNGKey(0))
        for i, p in enumerate(built[name][2].params):
            for k, v in p.items():
                out[f"{name}/p{i}_{k}"] = np.asarray(v)
    with open(sys.argv[3] + ".part", "wb") as f:
        np.savez(f, **out)
    os.replace(sys.argv[3] + ".part", sys.argv[3])
    for name, (plan, step, state) in built.items():
        params = state.params
        gstep = jax.jit(make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=2))
        compiled = gstep.lower(params, xs, ts).compile()
        text = compiled.as_text()
        # this XLA writes a loop's trip count as JSON ("known_trip_count":{"n":"2"})
        trips = {m.group(1): int(m.group(2)) for m in re.finditer(
            r'body=%?([\\w.-]+).*?"known_trip_count":\\{"n":"(\\d+)"\\}', text)}
        mult = 1
        for line in text.splitlines():
            comp = re.match(r"\\s*%?([\\w.-]+)\\s*\\(.*\\)\\s*->", line)
            if comp or line.startswith("ENTRY"):
                mult = trips.get(comp.group(1), 1) if comp else 1
                continue
            m = hlo._INSTR_RE.search(line)
            if not m or m.group("async") == "-done":
                continue
            kind, nbytes = m.group("op"), hlo._shape_bytes(m.group("result"))
            if kind == "collective-permute" and m.group("async") == "-start":
                nbytes //= 2
            for key, v in ((f"{kind}_count", mult), (f"{kind}_bytes", nbytes * mult)):
                out[f"{name}/{key}"] = out.get(f"{name}/{key}", 0) + v
        loss, grads = compiled(params, xs, ts)
        fwd, tiled = make_tiled_forward(plan, mesh), make_tiled_loss(plan, mesh, l2_loss_local)

        def rest(params, state):
            state, _ = jax.lax.scan(lambda st, b: (step(st, b)[0], None), state, stacked)
            return fwd(params, xs[0]), tiled(params, xs[0], ts[0]), state.params

        y, tl, final = jax.jit(rest)(params, state)
        out[f"{name}/loss"], out[f"{name}/fwd"], out[f"{name}/tloss"] = (
            np.asarray(loss), np.asarray(y), np.asarray(tl))
        for i, p in enumerate(params):
            for k, v in p.items():
                out[f"{name}/g{i}_{k}"] = np.asarray(grads[i][k])
                out[f"{name}/s{i}_{k}"] = np.asarray(final[i][k])
    np.savez(sys.argv[1], **out)
""")


def start_jax_ref(tmp_path_factory, plans: dict):
    """The reference in a subprocess with 4 fake devices, started before the
    first test; -> (process, its results' path, its inputs' path)."""
    import json

    path = tmp_path_factory.mktemp("jaxplans") / "ref.npz"
    init = path.with_name("init.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_REF, str(path), json.dumps(plans),
                             str(init)],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, path, init


def wait_jax_init(started) -> str:
    """The reference's inputs and initial params, which it writes before it
    compiles: the ranks run on them while it goes on."""
    proc, _, init = started
    deadline = time.monotonic() + 600
    while not init.exists():
        if proc.poll() is not None:
            assert init.exists(), proc.communicate()[0]
        assert time.monotonic() < deadline, "the reference wrote no inputs"
        time.sleep(0.05)
    return str(init)


def wait_jax_ref(started) -> str:
    proc, path, _ = started
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def _jax_started(tmp_path_factory):
    started = start_jax_ref(tmp_path_factory, PLANS)
    yield started
    if started[0].poll() is None:
        started[0].kill()
    started[0].communicate()


@pytest.fixture(scope="module")
def jax_init(_jax_started):
    return wait_jax_init(_jax_started)


@pytest.fixture(scope="module")
def jax_ref(_jax_started):
    return wait_jax_ref(_jax_started)


def tree_of(d, prefix):
    t = [{} for _ in LAYERS]
    pat = re.compile(re.escape(prefix) + r"(\d+)_(.+)$")
    for key in d.files:
        m = pat.match(key)
        if m:
            t[int(m.group(1))][m.group(2)] = d[key]
    return t


def leaves(tree):
    return [v for p in tree for v in p.values()]


def batch_of(step):
    """The reference launcher's batch recipe: 8 images, target 8x8x64."""
    r = np.random.default_rng([0, step])
    return {"x": torch.from_numpy(r.standard_normal((MICRO * MB, *HW, 3), np.float32)),
            "t": torch.from_numpy(0.05 * r.standard_normal((MICRO * MB, 8, 8, 64), np.float32))}


def plan_of(kw):
    return tfu.build_stack_plan(HW, LAYERS, 2, 2, [Group(s, e) for s, e in GROUPS],
                                backend="cuda", **kw)


def run_plan(mesh, plan, params0, xs, ts, dtype, record=None):
    """Loss, forward, deferred grads (2 microbatches) and the params after
    STEPS SGD steps of ``plan`` on ``mesh`` from ``params0`` in ``dtype``;
    a rank's record of the deferred step goes into ``record``."""
    params = [{k: v.to(dtype) for k, v in p.items()} for p in params0]
    xs, ts = xs.to(dtype), ts.to(dtype)
    loss = tfu.make_tiled_loss(plan, mesh, l2_loss_local)(params, xs[0], ts[0])
    fwd = tfu.make_tiled_forward(plan, mesh)(params, xs[0])
    step = tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=MICRO)
    if record is not None:
        mesh.group.take_record()
    dloss, grads = step(params, xs, ts)
    if record is not None:
        record.update(mesh.group.take_record())
    arch = TiledCNNArch(plan=plan, mesh=mesh, loss_local=l2_loss_local)
    tcfg = TrainConfig(lr=1e-3, optimizer="sgd", warmup=0, steps=STEPS)
    _, train_step = make_train_step(arch, ParallelConfig(grad_accum=MICRO), tcfg)
    p = [{k: v.clone() for k, v in q.items()} for q in params]
    state = TrainState(p, make_optimizer("sgd", weight_decay=tcfg.weight_decay).init(p), 0)
    for s in range(STEPS):
        state, _ = train_step(state, {k: v.to(dtype) for k, v in batch_of(s).items()})
    out = {"loss": loss.detach(), "fwd": fwd, "dloss": dloss, "grads": leaves(grads),
           "params": leaves(state.params)}
    return {k: ([t.numpy() for t in v] if isinstance(v, list) else v.numpy())
            for k, v in out.items()}


def plant(fault):
    """Patch this rank's process with ``fault``; -> a function that undoes
    it."""
    if fault == "swap_halves_exchanged":
        real = thalo._swap_send

        def hi_first(x, halo_lo, halo_hi, dim):
            size = x.shape[dim]
            return torch.cat([x.narrow(dim, 0, halo_hi),
                              x.narrow(dim, size - halo_lo, halo_lo)], dim=dim)

        thalo._swap_send = hi_first
        return lambda: setattr(thalo, "_swap_send", real)
    if fault == "tile_index_unoffset":
        real = thalo._tile_index

        def local(x, tile_dim):
            shape = [1] * x.dim()
            shape[tile_dim] = x.shape[tile_dim]
            return torch.arange(x.shape[tile_dim], device=x.device).reshape(shape)

        thalo._tile_index = local
        return lambda: setattr(thalo, "_tile_index", real)
    if fault == "batch_block_of_the_next_rank":
        real = tsp._rank_blocks

        def next_rank(blocks, mesh):
            n, m = blocks.shape[:2]
            flat = blocks.reshape(n * m, *blocks.shape[2:]).roll(-1, 0)
            return real(flat.reshape(blocks.shape), mesh)

        tsp._rank_blocks = next_rank
        return lambda: setattr(tsp, "_rank_blocks", real)
    raise ValueError(fault)


def scenario(group, ref_path, plans, faults, probe_overlap):
    """One rank: each plan on its block in fp32 and fp64, the virtual mesh
    beside it in this process, the record of the fp32 deferred step, the
    fp64 deferred grads under each planted fault, and (``probe_overlap``)
    how many permutes were on the wire at each conv call of one overlap
    forward."""
    torch.set_num_threads(1)
    d = np.load(ref_path)
    mesh = make_dist_tile_mesh(2, 2, "cpu", group)
    virtual = make_tile_mesh(2, 2, "cpu")
    xs, ts = torch.from_numpy(d["xs"]), torch.from_numpy(d["ts"])
    out = {"ranks": mesh.ranks, "plans": {}, "faults": {}}
    for name, kw in plans.items():
        plan = plan_of(kw)
        params0 = params_from_jax(tree_of(d, f"{name}/p"), "cpu")
        record = Counter()
        got = {"record": record}
        for dtype, tag in ((torch.float32, "fp32"), (torch.float64, "fp64")):
            got[tag] = run_plan(mesh, plan, params0, xs, ts, dtype,
                                record if tag == "fp32" else None)
            got[f"virtual_{tag}"] = run_plan(virtual, plan, params0, xs, ts, dtype)
        out["plans"][name] = got
    for fault, name in faults.items():
        plan = plan_of(plans[name])
        p64 = [{k: v.double() for k, v in p.items()}
               for p in params_from_jax(tree_of(d, f"{name}/p"), "cpu")]
        undo = plant(fault)
        try:
            step = tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=MICRO)
            loss, grads = step(p64, xs.double(), ts.double())
        finally:
            undo()
        out["faults"][fault] = [g.numpy() for g in leaves(grads)]
    if probe_overlap:
        real, post, land = tsp._conv_or_pool, tdist._post, tdist._land
        seen, posted = [], [0]

        def probe(*a, **k):
            seen.append(posted[0])
            return real(*a, **k)

        def counted_post(*a, **k):
            posted[0] += 1
            return post(*a, **k)

        def counted_land(*a, **k):
            posted[0] -= 1
            return land(*a, **k)

        tsp._conv_or_pool, tdist._post, tdist._land = probe, counted_post, counted_land
        try:
            params0 = params_from_jax(tree_of(d, "overlap/p"), "cpu")
            for m in (mesh, virtual):
                seen.append("mesh")
                tfu.make_tiled_forward(plan_of(PLANS["overlap"]), m)(params0, xs[0])
        finally:
            tsp._conv_or_pool, tdist._post, tdist._land = real, post, land
        out["in_flight_at_conv"] = seen
    return out


@pytest.fixture(scope="module")
def rank_runs(jax_init):
    return {w: run_ranks(scenario, w, "cpu",
                         args=(jax_init, PLANS, FAULTS if w == 4 else {}, w == 4), timeout=600)
            for w in (1, 2, 4)}


def rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
                 / max(1.0, float(np.max(np.abs(b)))))


KEYS = ("loss", "fwd", "dloss", "grads", "params")


def pairs(got, want, key):
    g, w = got[key], want[key]
    return list(zip(g, w)) if isinstance(g, list) else [(g, w)]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_one_rank_is_bitwise_the_virtual_mesh(rank_runs, name):
    """W = 1: the whole grid on one rank runs the virtual mesh's arithmetic
    (its swaps are local flips, its gathers and sums span one rank)."""
    (out,) = rank_runs[1]
    assert out["ranks"] == (1, 1)
    got = out["plans"][name]
    for tag in ("fp32", "fp64"):
        for key in KEYS:
            for g, w in pairs(got[tag], got[f"virtual_{tag}"], key):
                assert np.array_equal(g, w), (name, tag, key)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranks_match_the_virtual_mesh_in_fp64(rank_runs, name, world):
    outs = rank_runs[world]
    assert outs[0]["ranks"] == {2: (2, 1), 4: (2, 2)}[world]
    for out in outs:
        got = out["plans"][name]
        for key in KEYS:
            for g, w in pairs(got["fp64"], got["virtual_fp64"], key):
                assert rel(g, w) <= FP64_BAR, (name, world, key, rel(g, w))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranks_agree_with_each_other(rank_runs, name):
    """Every rank of W = 4 ends with the same loss, forward, gradients and
    params."""
    outs = rank_runs[4]
    for out in outs[1:]:
        for key in KEYS:
            for g, w in pairs(out["plans"][name]["fp32"], outs[0]["plans"][name]["fp32"], key):
                assert np.array_equal(g, w), (name, key)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranks_match_the_references_shard_map(rank_runs, jax_ref, name):
    """fp32 on 4 ranks against the reference's 2x2 shard_map: the tiled
    loss, the forward, the deferred step's loss and grads, and the params
    after 2 SGD steps of its trainer."""
    d = np.load(jax_ref)
    got = rank_runs[4][0]["plans"][name]["fp32"]
    np.testing.assert_allclose(got["loss"], d[f"{name}/tloss"], **TOL)
    np.testing.assert_allclose(got["fwd"], d[f"{name}/fwd"], **TOL)
    np.testing.assert_allclose(got["dloss"], d[f"{name}/loss"], **TOL)
    for g, w in zip(got["grads"], leaves(tree_of(d, f"{name}/g"))):
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    for g, w in zip(got["params"], leaves(tree_of(d, f"{name}/s"))):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_fp64_bar(rank_runs, fault):
    """Each fault moves the W = 4 deferred step's fp64 grads far past the
    bar the correct run meets."""
    out = rank_runs[4][1]
    want = out["plans"][FAULTS[fault]]["virtual_fp64"]["grads"]
    err = max(rel(g, w) for g, w in zip(out["faults"][fault], want))
    assert err > 1e6 * FP64_BAR, (fault, err)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_collectives_equal_the_references_and_the_model(rank_runs, jax_ref, name):
    """Every rank's record of the fp32 deferred step (2 microbatches): the
    permutes (the overlap plan: one swap a 2-tile axis a group input, each
    rank sending its whole packed strip; 12 = 2 groups x 2 axes forward +
    the second group's 2 backward, x 2 microbatches), the crossover's two
    all-gathers and their reduce-scatters, count and bytes, equal the
    reference's compiled step per device and ``plan_collectives``."""
    d = np.load(jax_ref)
    model = plan_collectives(plan_of(PLANS[name]), MB, (2, 2))
    for out in rank_runs[4]:
        st = collective_stats(out["plans"][name]["record"])
        for kind in KINDS:
            want = (int(d.get(f"{name}/{kind}_count", 0)), int(d.get(f"{name}/{kind}_bytes", 0)))
            got = (st.count.get(kind, 0), st.bytes_naive.get(kind, 0))
            assert got == want, (name, kind, got, want)
            assert got == tuple(MICRO * v for v in model.get(kind, (0, 0))), (name, kind, model)
    assert int(d["overlap/collective-permute_count"]) == 12
    assert int(d["crossover/all-gather_count"]) == int(d["crossover/reduce-scatter_count"]) == 4


def test_overlap_rows_are_on_the_wire_during_the_interior_conv(rank_runs):
    """On a rank of W = 4 the overlap lead of each group posts its row swap
    and issues its interior conv before landing it: that conv, and no
    other, sees a permute in flight.  The virtual mesh posts nothing."""
    seen = rank_runs[4][0]["in_flight_at_conv"]
    on_ranks, virtual = seen[1:seen.index("mesh", 1)], seen[seen.index("mesh", 1) + 1:]
    assert len(on_ranks) == len(virtual) and not any(virtual)
    assert on_ranks.count(1) == len(GROUPS) and set(on_ranks) == {0, 1}
    assert on_ranks[0] == 1, on_ranks


@pytest.mark.parametrize("flags,match", [
    (["--pipeline", "2"], "pipeline tails"),
    (["--cluster", "pi3x3+jetson"], "ragged partitions"),
])
def test_launcher_refusals_under_dist_name_their_item(flags, match, monkeypatch):
    """A pipeline tail and a heterogeneous cluster, once refused under
    ``--dist``, now pass the launcher's checks and go on to join the group
    torchrun describes (here there is none); so do they with a checkpoint
    directory and a fault schedule, once refused as ROADMAP A.20.2
    (elastic).  Their runs under torchrun:
    ``tests/test_torch_dist_ragged.py``, ``tests/test_torch_dist_pipeline.py``,
    ``tests/test_torch_dist_elastic.py``; ``match`` names what each case
    was refused as."""
    from repro_torch.launch.train import main

    for k in tdist.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    base = ["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "32", "--depth", "4",
            "--steps", "1", "--grid", "2", "--groups", "auto", "--no-batch-norm", "--dist"]
    assert match in ("pipeline tails", "ragged partitions")
    with pytest.raises(RuntimeError, match="no torchrun environment"):
        main(base + flags)
    with pytest.raises(RuntimeError, match="no torchrun environment"):
        main(base + flags + ["--ckpt-dir", "ckpt", "--fault-schedule", "drop:0@1"])


def test_plans_on_ranks_are_uniform_plans_of_any_schedule_crossover_and_codec():
    """``_dist_of`` takes every uniform plan the planner builds for a
    homogeneous cluster, before any collective."""
    group = tdist.TileGroup(0, 1, "gloo", torch.device("cpu"))
    mesh = make_dist_tile_mesh(2, 2, "cpu", group)
    for kw in (dict(schedule="overlap"), dict(crossover=2), dict(wire_codec="int8"),
               dict(schedule="overlap", crossover=2, wire_codec="topk:0.5")):
        plan = plan_of(kw)
        assert tfu._dist_of(mesh) is mesh
        tfu.make_tiled_infer(plan.inference_twin(), mesh)
    assert not group.record
