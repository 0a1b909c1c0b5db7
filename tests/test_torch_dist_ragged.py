"""Ragged partitions on ranks (``launch/mesh.py:DistTileMesh`` over
``parallel/dist.py``) against the virtual mesh and the JAX reference's
``shard_map`` on 4 fake devices.

The slice is the README's heterogeneous cluster: ``pi3x3+jetson`` on 2x2
(``groups="auto"``), YOLOv2's first 8 layers at 64x64, whose FLOPs-balanced
split gives tiles of 8 and 56 rows and columns, 2 microbatches of 4 images:
the shape-specialised executor (``ragged_exec="spec"``: one conv per shape
class a rank holds) and the padded one, each with and without a crossover
at layer 6 (``tests/test_torch_ragged.py``'s twin: the padded tiles
gathered along the rank rows and columns), and the padded plan under
``wire_codec="int8"``.  A ragged round on ranks ships each tile's lo and hi
strip on their own (the reference's two ``ppermute``s, in the padded order
hi first and the spec order lo first) and places them by an index built
for the block's sizes; BN sums are all-reduced once per layer.  CPU ranks
run gloo, one intra-op thread each, one spawn of ranks per world size:

- W = 1: the tiled loss, the forward, ``make_tiled_infer`` of the inference
  twin (BN frozen), the deferred gradients and the params after 2 SGD steps
  bitwise equal to the virtual mesh;
- W = 2 (a tile row a rank) and W = 4 (a tile a rank, blocks of unequal
  valid extents): the same in fp64 within ``FP64_BAR`` of the virtual mesh
  (the int8 plan within the codec bar of ``tests/test_torch_dist_codecs.py``,
  its none twin the padded plan);
- W = 4 in fp32 against the reference's 2x2 ``shard_map`` (backend
  "pallas", interpret mode): the loss, the forward, the inference forward
  and the deferred step's loss and grads within ``tests/test_kernels.py:23``'s
  tolerances (grads: its ``:201``), the int8 plan within the codec bar;
- W = 4: planted faults fail the fp64 bar - a block's size table read from
  the grid's first tiles, the ragged BN sums not all-reduced;
- W = 4: every rank's ``collective-permute``, ``all-gather`` and
  ``reduce-scatter`` (``all-to-all`` under int8) over the fp32 deferred
  step equal, count and bytes, the reference's compiled step per device
  and ``analysis/collectives.py:plan_collectives``;
- the launcher under torchrun with 2 gloo ranks and ``--cluster
  pi3x3+jetson`` gives the plain launcher's loss.

The reference runs in a subprocess started before the first test, so its
compiles overlap the spawns (``start_jax_ref``; the pipeline tails'
``tests/test_torch_dist_pipeline.py`` shares it).
"""
import json
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
from repro_torch.core import spatial as tsp
from repro_torch.core.tiling import Group
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import DistTileMesh, make_dist_tile_mesh, make_tile_mesh
from repro_torch.models.tiled_cnn import TiledCNNArch
from repro_torch.models.yolo import l2_loss_local, yolov2_16_layers
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.parallel import dist as tdist
from repro_torch.parallel.dist import run_ranks
from repro_torch.train.trainer import TrainState, make_train_step
from test_torch_dist_codecs import within_codec_bar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=2e-5, rtol=1e-4)           # tests/test_kernels.py:23, fp32
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)      # tests/test_kernels.py:201, fp32 grads
FP64_BAR = 1e-12                           # ranks vs the virtual mesh, fp64, x max(1, |ref|)
CODEC_BAR = 0.1                            # tests/test_torch_wire_codec.py:89
STEPS = 2
CLUSTER = dict(stack="yolo", depth=8, hw=[64, 64], grid=[2, 2], groups="auto", micro=2, mb=4,
               kw=dict(hw="pi3x3+jetson", batch=8, microbatches=2))
PLANS = {
    "spec": CLUSTER,
    "padded": dict(CLUSTER, kw=dict(CLUSTER["kw"], ragged_exec="padded")),
    "spec_crossover": dict(CLUSTER, kw=dict(CLUSTER["kw"], crossover=6)),
    "padded_crossover": dict(CLUSTER, kw=dict(CLUSTER["kw"], crossover=6, ragged_exec="padded")),
    "padded_int8": dict(CLUSTER, kw=dict(CLUSTER["kw"], ragged_exec="padded", wire_codec="int8")),
}
NONE_TWIN = {"padded_int8": "padded"}
FAULTS = {"block_sizes_of_the_first_tiles": "spec", "bn_sums_not_all_reduced": "padded"}
KINDS = ("collective-permute", "all-gather", "reduce-scatter", "all-to-all")
KEYS = ("loss", "fwd", "infer", "dloss", "grads", "params")

# The reference's plans, one process with 4 fake devices.  ``sys.argv[2]``
# holds the plans as JSON: the stack ("yolo" or "yolo_nobn" and its depth,
# or a list of LayerDef fields), the map, the grid, the groups, the planner
# kwargs, M microbatches of ``mb`` images.  First each plan's inputs (xs,
# ts), the trainer's two batches and its initial params go to
# ``sys.argv[3]`` (written whole, then renamed), so that the ranks start on
# them while the reference compiles.  Then per
# plan the deferred step compiled once (its HLO's collectives, each times
# its loop's trip count, and apart those inside a loop) and that
# executable called, and one jitted call of the tiled loss, of the forward
# (not for a pipeline plan), and of the inference twin on params with BN
# frozen on xs[0] (a plan with "infer").
_JAX_REF = textwrap.dedent("""
    import json, os, re, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.analysis import hlo
    from repro.configs.base import ParallelConfig, TrainConfig
    from repro.core.fusion import (build_stack_plan, make_deferred_grad_step,
                                   make_tiled_forward, make_tiled_infer, make_tiled_loss)
    from repro.core.spatial import LayerDef, freeze_bn_stats
    from repro.core.tiling import Group
    from repro.launch.mesh import make_tile_mesh
    from repro.models.tiled_cnn import TiledCNNArch
    from repro.models.yolo import l2_loss_local, yolov2_16_layers
    from repro.train.trainer import make_train_step
    out, built = {}, {}
    for i, (name, p) in enumerate(json.loads(sys.argv[2]).items()):
        layers = ([LayerDef(**l) for l in p["stack"]] if isinstance(p["stack"], list)
                  else yolov2_16_layers(batch_norm=p["stack"] == "yolo")[:p["depth"]])
        n, m = p["grid"]
        groups = p["groups"] if isinstance(p["groups"], str) else [Group(*g) for g in p["groups"]]
        plan = build_stack_plan(tuple(p["hw"]), layers, n, m, groups, backend="pallas",
                                **p["kw"])
        mesh = make_tile_mesh(n, m)
        arch = TiledCNNArch(plan=plan, mesh=mesh, loss_local=l2_loss_local)
        init_state, _ = make_train_step(arch, ParallelConfig(grad_accum=p["micro"]),
                                        TrainConfig(lr=1e-3, optimizer="sgd", warmup=0, steps=2))
        r = np.random.default_rng(9 + i)
        oh, ow = plan.map_hw[-1]
        c = layers[-1].out_channels
        out[f"{name}/xs"] = r.standard_normal((p["micro"], p["mb"], *p["hw"], 3)).astype(np.float32)
        out[f"{name}/ts"] = (0.05 * r.standard_normal((p["micro"], p["mb"], oh, ow, c))
                             ).astype(np.float32)
        for s in range(2):
            rr = np.random.default_rng([i, s])
            out[f"{name}/b{s}_x"] = rr.standard_normal((p["micro"] * p["mb"], *p["hw"], 3),
                                                       np.float32)
            out[f"{name}/b{s}_t"] = (0.05 * rr.standard_normal((p["micro"] * p["mb"], oh, ow, c))
                                     ).astype(np.float32)
        params = init_state(jax.random.PRNGKey(0)).params
        for j, q in enumerate(params):
            for k, v in q.items():
                out[f"{name}/p{j}_{k}"] = np.asarray(v)
        built[name] = plan, mesh, params, p
    with open(sys.argv[3] + ".part", "wb") as f:
        np.savez(f, **out)
    os.replace(sys.argv[3] + ".part", sys.argv[3])
    for name, (plan, mesh, params, p) in built.items():
        xs, ts = out[f"{name}/xs"], out[f"{name}/ts"]
        gstep = jax.jit(make_deferred_grad_step(plan, mesh, l2_loss_local,
                                                microbatches=p["micro"]))
        compiled = gstep.lower(params, xs, ts).compile()
        text = compiled.as_text()
        # this XLA writes a loop's trip count as JSON ("known_trip_count":{"n":"2"})
        trips = {g.group(1): int(g.group(2)) for g in re.finditer(
            r'body=%?([\\w.-]+).*?"known_trip_count":\\{"n":"(\\d+)"\\}', text)}
        mult = 1
        for line in text.splitlines():
            comp = re.match(r"\\s*%?([\\w.-]+)\\s*\\(.*\\)\\s*->", line)
            if comp or line.startswith("ENTRY"):
                mult = trips.get(comp.group(1), 1) if comp else 1
                continue
            g = hlo._INSTR_RE.search(line)
            if not g or g.group("async") == "-done":
                continue
            kind, nbytes = g.group("op"), hlo._shape_bytes(g.group("result"))
            if kind == "collective-permute" and g.group("async") == "-start":
                nbytes //= 2
            for key, v in ((f"{kind}_count", mult), (f"{kind}_bytes", nbytes * mult)):
                out[f"{name}/{key}"] = out.get(f"{name}/{key}", 0) + v
                if mult > 1:                    # inside the microbatch or tick loop
                    out[f"{name}/loop_{key}"] = out.get(f"{name}/loop_{key}", 0) + v
        loss, grads = compiled(params, xs, ts)
        out[f"{name}/dloss"] = np.asarray(loss)
        for j, q in enumerate(grads):
            for k, v in q.items():
                out[f"{name}/g{j}_{k}"] = np.asarray(v)
        out[f"{name}/loss"] = np.asarray(
            jax.jit(make_tiled_loss(plan, mesh, l2_loss_local))(params, xs[0], ts[0]))
        if not plan.stages:
            out[f"{name}/fwd"] = np.asarray(jax.jit(make_tiled_forward(plan, mesh))(params, xs[0]))
        if p.get("infer"):
            frozen = freeze_bn_stats(params, plan.layers, xs[0])
            out[f"{name}/infer"] = np.asarray(
                jax.jit(make_tiled_infer(plan.inference_twin(), mesh))(frozen, xs[1]))
    for k in list(out):
        if k.endswith(("/xs", "/ts")) or "/b0_" in k or "/b1_" in k or re.search(r"/p\\d+_", k):
            del out[k]
    np.savez(sys.argv[1], **out)
""")


def start_jax_ref(tmp_path_factory, plans: dict):
    """The reference in a subprocess with 4 fake devices, started before the
    first test; -> (process, its results' path, its inputs' path)."""
    path = tmp_path_factory.mktemp("jaxdist") / "ref.npz"
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
    started = start_jax_ref(tmp_path_factory, {k: dict(v, infer=True) for k, v in PLANS.items()})
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


def tree_of(d, prefix, n_layers):
    """Per layer, the arrays saved under ``prefix``, keys sorted (the order
    of the reference's gradient dicts, which its params need not share)."""
    t = [{} for _ in range(n_layers)]
    pat = re.compile(re.escape(prefix) + r"(\d+)_(.+)$")
    for key in d.files:
        g = pat.match(key)
        if g:
            t[int(g.group(1))][g.group(2)] = d[key]
    return [dict(sorted(p.items())) for p in t]


def leaves(tree):
    return [v for p in tree for v in p.values()]


def layers_of(spec: dict):
    if isinstance(spec["stack"], list):
        return [tsp.LayerDef(**l) for l in spec["stack"]]
    return yolov2_16_layers(batch_norm=spec["stack"] == "yolo")[:spec["depth"]]


def plan_of(spec: dict):
    layers = layers_of(spec)
    groups = (spec["groups"] if isinstance(spec["groups"], str)
              else [Group(*g) for g in spec["groups"]])
    return tfu.build_stack_plan(tuple(spec["hw"]), layers, *spec["grid"], groups, backend="cuda",
                                **spec["kw"])


def run_plan(mesh, plan, spec, d, name, dtype, record=None):
    """The tiled loss, the forward and the inference forward (not for a
    pipeline plan), the deferred grads (M microbatches) and the params
    after STEPS SGD steps of ``plan`` on ``mesh`` from the reference's
    initial params, in ``dtype``; a rank's record of the deferred step
    goes into ``record``."""
    params = [{k: v.to(dtype) for k, v in p.items()}
              for p in params_from_jax(tree_of(d, f"{name}/p", len(plan.layers)), "cpu")]
    xs = torch.from_numpy(d[f"{name}/xs"]).to(dtype)
    ts = torch.from_numpy(d[f"{name}/ts"]).to(dtype)
    out = {}
    if not plan.stages:
        out["fwd"] = tfu.make_tiled_forward(plan, mesh)(params, xs[0])
        frozen = tsp.freeze_bn_stats(params, plan.layers, xs[0])
        out["infer"] = tfu.make_tiled_infer(plan.inference_twin(), mesh)(frozen, xs[1])
    out["loss"] = tfu.make_tiled_loss(plan, mesh, l2_loss_local)(params, xs[0], ts[0]).detach()
    step = tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=spec["micro"])
    if record is not None:
        mesh.group.take_record()
    out["dloss"], grads = step(params, xs, ts)
    if record is not None:
        record.update(mesh.group.take_record())
    out["grads"] = leaves(grads)
    arch = TiledCNNArch(plan=plan, mesh=mesh, loss_local=l2_loss_local)
    tcfg = TrainConfig(lr=1e-3, optimizer="sgd", warmup=0, steps=STEPS)
    _, train_step = make_train_step(arch, ParallelConfig(grad_accum=spec["micro"]), tcfg)
    p = [{k: v.clone() for k, v in q.items()} for q in params]
    state = TrainState(p, make_optimizer("sgd", weight_decay=tcfg.weight_decay).init(p), 0)
    for s in range(STEPS):
        batch = {k: torch.from_numpy(d[f"{name}/b{s}_{k}"]).to(dtype) for k in ("x", "t")}
        state, _ = train_step(state, batch)
    out["params"] = leaves(state.params)
    return {k: ([t.numpy() for t in v] if isinstance(v, list) else v.numpy())
            for k, v in out.items()}


def plant(fault):
    """Patch this rank's process with ``fault``; -> a function that undoes
    it."""
    if fault == "block_sizes_of_the_first_tiles":
        real = DistTileMesh.block_table

        def first_tiles(self, table, dim):
            return tuple(table[:self.block[dim]])

        DistTileMesh.block_table = first_tiles
        return lambda: setattr(DistTileMesh, "block_table", real)
    if fault == "bn_sums_not_all_reduced":
        real = tsp._global_sums
        tsp._global_sums = lambda s, ss: (s, ss)
        return lambda: setattr(tsp, "_global_sums", real)
    raise ValueError(fault)


def runs_of(group) -> tuple[tuple[str, bool], ...]:
    """The (dtype tag, with the virtual mesh) runs of a rank: fp32 and fp64
    at W = 1, each beside the virtual mesh; fp64 at W = 2; fp32 and fp64
    at W = 4.  Only rank 0 runs the virtual mesh beside its fp64 run (the
    other ranks are held to it): every rank's would be the same."""
    tags = {1: ("fp32", "fp64"), 2: ("fp64",)}.get(group.world, ("fp32", "fp64"))
    return tuple((t, group.world == 1 or (group.rank == 0 and t == "fp64")) for t in tags)


def scenario(group, ref_path, plans, faults):
    """One rank: each plan on its block (``runs_of``), the virtual mesh
    beside it, the record of the fp32 deferred step, and the fp64 deferred
    grads under each planted fault."""
    torch.set_num_threads(1)
    d = np.load(ref_path)
    out = {"ranks": None, "plans": {}, "faults": {}}
    for name, spec in plans.items():
        plan = plan_of(spec)
        mesh = make_dist_tile_mesh(*spec["grid"], "cpu", group)
        virtual = make_tile_mesh(*spec["grid"], "cpu")
        out["ranks"] = mesh.ranks
        record = Counter()
        got = {"record": record, "coord": mesh.coord}
        for tag, with_virtual in runs_of(group):
            dtype = {"fp32": torch.float32, "fp64": torch.float64}[tag]
            got[tag] = run_plan(mesh, plan, spec, d, name, dtype, record if tag == "fp32" else None)
            if with_virtual:
                got[f"virtual_{tag}"] = run_plan(virtual, plan, spec, d, name, dtype)
        out["plans"][name] = got
    for fault, name in faults.items():
        spec = plans[name]
        mesh = make_dist_tile_mesh(*spec["grid"], "cpu", group)
        p64 = [{k: v.double() for k, v in p.items()} for p in
               params_from_jax(tree_of(d, f"{name}/p", len(layers_of(spec))), "cpu")]
        undo = plant(fault)
        try:
            step = tfu.make_deferred_grad_step(plan_of(spec), mesh, l2_loss_local,
                                               microbatches=spec["micro"])
            _, grads = step(p64, torch.from_numpy(d[f"{name}/xs"]).double(),
                            torch.from_numpy(d[f"{name}/ts"]).double())
        finally:
            undo()
        out["faults"][fault] = [g.numpy() for g in leaves(grads)]
    return out


@pytest.fixture(scope="module")
def rank_runs(jax_init):
    return {w: run_ranks(scenario, w, "cpu", args=(jax_init, PLANS, FAULTS if w == 4 else {}),
                         timeout=300)
            for w in (1, 2, 4)}


def rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
                 / max(1.0, float(np.max(np.abs(b)))))


def pairs(got, want, key):
    g, w = got[key], want[key]
    return list(zip(g, w)) if isinstance(g, list) else [(g, w)]


def over_codec_bar(got, codec, none, keys):
    """The keys of ``got`` past ``within_codec_bar`` at CODEC_BAR."""
    over = {}
    for key in keys:
        for i, (a, b) in enumerate(pairs(got, codec, key)):
            e = none[key][i] if isinstance(none[key], list) else none[key]
            err, lim = within_codec_bar(a, b, e, CODEC_BAR)
            if err > lim:
                over[f"{key}{i}"] = (err, lim)
    return over


@pytest.mark.parametrize("name", sorted(PLANS))
def test_one_rank_is_bitwise_the_virtual_mesh(rank_runs, name):
    """W = 1: the whole grid on one rank runs the virtual mesh's arithmetic
    (its strips move within the block, its sums span one rank)."""
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
    want = outs[0]["plans"][name]["virtual_fp64"]
    for out in outs:
        got = out["plans"][name]
        if name in NONE_TWIN:
            none = outs[0]["plans"][NONE_TWIN[name]]["virtual_fp64"]
            over = over_codec_bar(got["fp64"], want, none, KEYS)
            assert not over, (name, world, over)
            continue
        for key in KEYS:
            for g, w in pairs(got["fp64"], want, key):
                assert rel(g, w) <= FP64_BAR, (name, world, key, rel(g, w))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranks_agree_with_each_other(rank_runs, name):
    """Every rank of W = 4 ends with the same loss, forward, gradients and
    params, bit for bit."""
    outs = rank_runs[4]
    for out in outs[1:]:
        for key in KEYS:
            for g, w in pairs(out["plans"][name]["fp32"], outs[0]["plans"][name]["fp32"], key):
                assert np.array_equal(g, w), (name, key)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranks_match_the_references_shard_map(rank_runs, jax_ref, name):
    """fp32 on 4 ranks against the reference's 2x2 shard_map: the tiled
    loss, the forward, the inference forward, the deferred step's loss and
    grads; the int8 plan within the codec bar (its none twin's run on the
    ranks gives the codec's effect)."""
    d = np.load(jax_ref)
    got = rank_runs[4][0]["plans"][name]["fp32"]
    ref = {"loss": d[f"{name}/loss"], "fwd": d[f"{name}/fwd"], "infer": d[f"{name}/infer"],
           "dloss": d[f"{name}/dloss"], "grads": leaves(tree_of(d, f"{name}/g", 8))}
    if name in NONE_TWIN:
        none = rank_runs[4][0]["plans"][NONE_TWIN[name]]["fp32"]
        over = over_codec_bar(got, ref, none, tuple(ref))
        assert not over, over
        return
    for key in ("loss", "fwd", "infer", "dloss"):
        np.testing.assert_allclose(got[key], ref[key], **TOL, err_msg=key)
    for g, w in zip(got["grads"], ref["grads"]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_fp64_bar(rank_runs, fault):
    """Each fault moves the W = 4 deferred step's fp64 grads far past the
    bar the correct run meets: a block's sizes taken from the grid's
    first tiles (the exchange places the strips, and the masks clip the
    tiles, at another tile's extent), and BN's two sums left per rank."""
    out = rank_runs[4][1]
    want = rank_runs[4][0]["plans"][FAULTS[fault]]["virtual_fp64"]["grads"]
    err = max(rel(g, w) for g, w in zip(out["faults"][fault], want))
    assert err > 1e6 * FP64_BAR, (fault, err)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_collectives_equal_the_references_and_the_model(rank_runs, jax_ref, name):
    """Every rank's record of the fp32 deferred step (2 microbatches): each
    round's two strips (the image's forward only), a crossover's two
    gathers of the padded tiles and their reduce-scatters, the int8 plan's
    payload leaves, count and bytes, equal ``plan_collectives`` and the
    reference's compiled step per device, inside its microbatch loop.  The
    spec plans' steps have nothing outside it; the padded plans' also move
    a few strips of both microbatches at once outside it (collective-
    permutes and all-to-alls in shapes led by the microbatch count: XLA's
    rewrite of the padded exchange's dynamic slices), which the port has
    no counterpart of."""
    d = np.load(jax_ref)
    spec = PLANS[name]
    plan = plan_of(spec)
    for out in rank_runs[4]:
        got_plan = out["plans"][name]
        model = plan_collectives(plan, spec["mb"], (2, 2), got_plan["coord"])
        st = collective_stats(got_plan["record"])
        for kind in KINDS:
            got = (st.count.get(kind, 0), st.bytes_naive.get(kind, 0))
            assert got == tuple(spec["micro"] * v for v in model.get(kind, (0, 0))), (
                name, kind, model)
            in_loop = tuple(int(d.get(f"{name}/loop_{kind}_{x}", 0)) for x in ("count", "bytes"))
            total = tuple(int(d.get(f"{name}/{kind}_{x}", 0)) for x in ("count", "bytes"))
            assert got == in_loop, (name, kind, got, in_loop)
            if plan.ragged_exec == "spec":
                assert total == in_loop, (name, kind, total)


def test_launcher_on_two_ranks_runs_the_cluster_and_gives_the_plain_launchers_loss(capsys):
    """``torchrun --nproc-per-node 2 ... --cluster pi3x3+jetson --dist``
    (gloo, a tile row a rank): one plan line, the ragged partition, and
    the plain launcher's loss and gradient norm."""
    from repro_torch.launch.train import main

    flags = ["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "64", "--depth", "8",
             "--grid", "2", "--cluster", "pi3x3+jetson", "--groups", "auto", "--batch", "4",
             "--grad-accum", "2", "--steps", "2", "--optimizer", "sgd"]
    assert main(flags) == 0
    plain = capsys.readouterr().out
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *flags,
                          "--dist", "--dist-backend", "gloo"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert sum(ln.startswith("plan:") for ln in run.stdout.splitlines()) == 1
    assert "dist=2 ranks=2x1 backend=gloo" in run.stdout
    assert "uniform=False cluster=pi3x3+jetson" in run.stdout

    def done(text):
        (line,) = [ln for ln in text.splitlines() if ln.startswith("done:")]
        return line.split("loss=")[1]

    assert done(run.stdout) == done(plain)


def test_ragged_plans_on_ranks_reach_no_collective_when_built():
    """``_dist_of`` takes every ragged plan, and building the entry points
    on ranks issues no collective."""
    group = tdist.TileGroup(0, 1, "gloo", torch.device("cpu"))
    mesh = make_dist_tile_mesh(2, 2, "cpu", group)
    for spec in PLANS.values():
        plan = plan_of(spec)
        assert not plan.is_uniform and tfu._dist_of(mesh) is mesh
        tfu.make_tiled_forward(plan, mesh)
        tfu.make_tiled_loss(plan, mesh, l2_loss_local)
        tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=2)
        tfu.make_tiled_infer(plan.inference_twin(), mesh)
    assert not group.record
