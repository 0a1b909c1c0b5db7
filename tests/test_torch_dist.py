"""The tiled CNN on ranks (``launch/mesh.py:DistTileMesh`` over
``parallel/dist.py``) against the virtual mesh and the JAX reference's
``shard_map`` on 4 fake devices.

The slice is the paper's training step on a 2x2 grid: YOLOv2's first 4
layers (BN, two pools) at 32x32, groups (0-1)(2-3), the uniform sync plan,
2 microbatches of 2 images.  CPU ranks run gloo, one intra-op thread each,
one spawn of ranks per scenario (``run_ranks``):

- W = 1 (the whole grid on one rank): the loss, the forward, the deferred
  gradients and the params after 2 SGD steps bitwise equal to the virtual
  mesh (``make_tile_mesh``) in the same process;
- W = 2 (blocks of two tiles) and W = 4 (one tile a rank): the same four
  in fp64 within ``FP64_BAR`` of the virtual mesh, and in fp32 against the
  reference's 2x2 ``shard_map`` (backend "pallas", interpret mode) within
  ``tests/test_kernels.py:23``'s tolerances (grads: its ``:201``);
- W = 4: three planted faults fail the fp64 bar - the loss all-reduced
  ahead of the backward (every gradient W times), a strip delivered from
  the wrong neighbour, BN sums left unreduced;
- W = 4: the halo bytes a rank records equal the reference's
  collective-permute bytes per device of the same compiled step times the
  microbatch loop's trip count, and ``analysis/collectives.py``'s model;
- the launcher under torchrun with 2 gloo ranks gives the plain
  launcher's loss; every refusal of the slice names its ROADMAP item.
"""
import os
import subprocess
import sys
import textwrap
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.analysis.collectives import collective_stats, halo_permute_bytes
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import fusion as tfu
from repro_torch.core import spatial as tsp
from repro_torch.core.tiling import Group
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import DistTileMesh, make_dist_tile_mesh, make_tile_mesh
from repro_torch.models.tiled_cnn import TiledCNNArch
from repro_torch.models.yolo import l2_loss_local, yolov2_16_layers
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.parallel.dist import TileGroup, all_reduce_sum, run_ranks
from repro_torch.train.trainer import TrainState, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (32, 32)
GROUPS = [(0, 1), (2, 3)]
LAYERS = yolov2_16_layers()[:4]
STEPS = 2
TOL = dict(atol=2e-5, rtol=1e-4)           # tests/test_kernels.py:23, fp32
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)      # tests/test_kernels.py:201, fp32 grads
FP64_BAR = 1e-12                           # ranks vs the virtual mesh, fp64, x max(1, |ref|)
FAULTS = ("loss_reduced_before_backward", "wrong_neighbour", "bn_sums_unreduced")

_JAX_REF = textwrap.dedent("""
    import os, re, sys
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
    plan = build_stack_plan((32, 32), yolov2_16_layers()[:4], 2, 2,
                            [Group(0, 1), Group(2, 3)], backend="pallas")
    arch = TiledCNNArch(plan=plan, mesh=mesh, loss_local=l2_loss_local)
    init_state, step = make_train_step(arch, ParallelConfig(grad_accum=2),
                                       TrainConfig(lr=1e-3, optimizer="sgd", warmup=0, steps=2))
    state = init_state(jax.random.PRNGKey(0))
    params = state.params
    r = np.random.default_rng(9)
    xs = r.standard_normal((2, 2, 32, 32, 3)).astype(np.float32)
    ts = (0.05 * r.standard_normal((2, 2, 8, 8, 64))).astype(np.float32)
    gstep = jax.jit(make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=2))
    text = gstep.lower(params, xs, ts).compile().as_text()
    # this XLA writes a loop's trip count as JSON ("known_trip_count":{"n":"2"}),
    # which hlo.scan_trip_counts and hlo.collectives_with_loops do not read
    trips = {m.group(1): int(m.group(2)) for m in re.finditer(
        r'body=%?([\\w.-]+).*?"known_trip_count":\\{"n":"(\\d+)"\\}', text)}
    out = {"xs": xs, "ts": ts, "hlo_scan_trip_counts": np.asarray(hlo.scan_trip_counts(text))}
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
        for key, v in ((f"{kind}_count", mult), (f"{kind}_bytes", nbytes * mult),
                       (f"{kind}_count_in_loop", int(mult > 1)),
                       (f"{kind}_trip", mult if mult > 1 else 0)):
            out[key] = out.get(key, 0) + v
    loss, grads = gstep(params, xs, ts)
    out["loss"] = np.asarray(loss)
    out["fwd"] = np.asarray(jax.jit(make_tiled_forward(plan, mesh))(params, xs[0]))
    out["tloss"] = np.asarray(jax.jit(make_tiled_loss(plan, mesh, l2_loss_local))(
        params, xs[0], ts[0]))
    step = jax.jit(step)
    for s in range(2):
        rr = np.random.default_rng([0, s])
        state, _ = step(state, {"x": rr.standard_normal((4, 32, 32, 3), np.float32),
                                "t": 0.05 * rr.standard_normal((4, 8, 8, 64), np.float32)})
    for i, p in enumerate(params):
        for k, v in p.items():
            out[f"p{i}_{k}"] = np.asarray(v)
            out[f"g{i}_{k}"] = np.asarray(grads[i][k])
            out[f"s{i}_{k}"] = np.asarray(state.params[i][k])
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module", autouse=True)
def _jax_started(tmp_path_factory):
    """The reference runs in a subprocess with 4 fake devices, started
    before the first test so that it overlaps the ranks' spawns."""
    path = tmp_path_factory.mktemp("jaxdist") / "ref.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", _JAX_REF, str(path)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_ref(_jax_started):
    proc, path = _jax_started
    out, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, out
    return str(path)


def _tree(d, prefix):
    t = [{} for _ in LAYERS]
    for key in d.files:
        if key.startswith(prefix) and key[len(prefix)].isdigit():
            i, k = key[len(prefix):].split("_", 1)
            t[int(i)][k] = d[key]
    return t


def _batch(step):
    """The reference launcher's batch recipe: 4 images, target 8x8x64."""
    r = np.random.default_rng([0, step])
    return {"x": torch.from_numpy(r.standard_normal((4, *HW, 3), np.float32)),
            "t": torch.from_numpy(0.05 * r.standard_normal((4, 8, 8, 64), np.float32))}


def _plan():
    return tfu.build_stack_plan(HW, LAYERS, 2, 2, [Group(s, e) for s, e in GROUPS],
                                backend="cuda")


def _leaves(tree):
    return [v for p in tree for v in p.values()]


def _run(mesh, params0, xs, ts, dtype, record=None):
    """Loss, forward, deferred grads (2 microbatches) and the params after
    STEPS SGD steps on ``mesh`` from ``params0`` in ``dtype``; a rank's
    record of the deferred step goes into ``record``."""
    plan = _plan()
    params = [{k: v.to(dtype) for k, v in p.items()} for p in params0]
    xs, ts = xs.to(dtype), ts.to(dtype)
    loss = tfu.make_tiled_loss(plan, mesh, l2_loss_local)(params, xs[0], ts[0])
    fwd = tfu.make_tiled_forward(plan, mesh)(params, xs[0])
    step = tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=2)
    if record is not None:
        mesh.group.take_record()
    dloss, grads = step(params, xs, ts)
    if record is not None:
        record += mesh.group.take_record()
    arch = TiledCNNArch(plan=plan, mesh=mesh, loss_local=l2_loss_local)
    tcfg = TrainConfig(lr=1e-3, optimizer="sgd", warmup=0, steps=STEPS)
    _, train_step = make_train_step(arch, ParallelConfig(grad_accum=2), tcfg)
    p = [{k: v.clone() for k, v in q.items()} for q in params]
    state = TrainState(p, make_optimizer("sgd", weight_decay=tcfg.weight_decay).init(p), 0)
    for s in range(STEPS):
        state, _ = train_step(state, {k: v.to(dtype) for k, v in _batch(s).items()})
    return {"loss": loss.detach(), "fwd": fwd, "dloss": dloss,
            "grads": _leaves(grads), "params": _leaves(state.params)}


def _plant(fault, group):
    """Patch this rank's process with ``fault``; returns the loss_local to
    use."""
    if fault == "loss_reduced_before_backward":
        def reduced(y, t):
            s, c = l2_loss_local(y, t)
            return all_reduce_sum(s, group), c
        return reduced
    if fault == "wrong_neighbour":
        real = DistTileMesh.neighbour

        def mirrored(self, dim, step):
            """Row strips go to (and come from) the rank mirrored across the
            columns: a consistent pairing, so the ranks do not hang."""
            r = real(self, dim, step)
            if r is None or dim != 0:
                return r
            pr, pc = divmod(r, self.ranks[1])
            return pr * self.ranks[1] + (self.ranks[1] - 1 - pc)
        DistTileMesh.neighbour = mirrored
    elif fault == "bn_sums_unreduced":
        tsp.all_reduce_sum = lambda t, g: t
    return l2_loss_local


def _np(run):
    return {k: ([t.numpy() for t in v] if isinstance(v, list) else v.numpy())
            for k, v in run.items()}


def _scenario(group, ref_path, faults):
    """One rank: the slice on its block in fp32 and fp64, the virtual mesh
    beside it in this process, the record of the fp32 deferred step, and
    the fp64 deferred grads under each planted fault."""
    torch.set_num_threads(1)
    d = np.load(ref_path)
    params0 = params_from_jax(_tree(d, "p"), "cpu")
    xs, ts = torch.from_numpy(d["xs"]), torch.from_numpy(d["ts"])
    mesh = make_dist_tile_mesh(2, 2, "cpu", group)
    virtual = make_tile_mesh(2, 2, "cpu")
    record = Counter()
    out = {"ranks": mesh.ranks, "block": mesh.block}
    for dtype, tag in ((torch.float32, "fp32"), (torch.float64, "fp64")):
        out[tag] = _np(_run(mesh, params0, xs, ts, dtype, record if tag == "fp32" else None))
        out[f"virtual_{tag}"] = _np(_run(virtual, params0, xs, ts, dtype))
    out["record"] = record
    out["faults"] = {}
    plan = _plan()
    p64 = [{k: v.double() for k, v in p.items()} for p in params0]
    for fault in faults:
        saved = DistTileMesh.neighbour, tsp.all_reduce_sum
        try:
            loss_local = _plant(fault, group)
            step = tfu.make_deferred_grad_step(plan, mesh, loss_local, microbatches=2)
            loss, grads = step(p64, xs.double(), ts.double())
        finally:
            DistTileMesh.neighbour, tsp.all_reduce_sum = saved
        out["faults"][fault] = {"dloss": loss.numpy(), "grads": [g.numpy() for g in _leaves(grads)]}
    return out


@pytest.fixture(scope="module")
def rank_runs(jax_ref):
    return {w: run_ranks(_scenario, w, "cpu", args=(jax_ref, FAULTS if w == 4 else ()),
                         timeout=600)
            for w in (1, 2, 4)}


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
                 / max(1.0, float(np.max(np.abs(b)))))


KEYS = ("loss", "fwd", "dloss", "grads", "params")


def _pairs(got, want, key):
    g, w = got[key], want[key]
    return list(zip(g, w)) if isinstance(g, list) else [(g, w)]


def test_one_rank_is_bitwise_the_virtual_mesh(rank_runs):
    """W = 1: the whole grid on one rank runs the virtual mesh's arithmetic
    (its collectives sum one rank) - loss, forward, deferred grads and
    params after 2 SGD steps equal bit for bit, in fp32 and fp64."""
    (out,) = rank_runs[1]
    assert out["ranks"] == (1, 1)
    for tag in ("fp32", "fp64"):
        for key in KEYS:
            for g, w in _pairs(out[tag], out[f"virtual_{tag}"], key):
                assert np.array_equal(g, w), (tag, key)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_the_virtual_mesh_in_fp64(rank_runs, world):
    outs = rank_runs[world]
    assert outs[0]["ranks"] == {2: (2, 1), 4: (2, 2)}[world]
    for out in outs:
        for key in KEYS:
            for g, w in _pairs(out["fp64"], out["virtual_fp64"], key):
                assert _rel(g, w) <= FP64_BAR, (world, key, _rel(g, w))


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_agree_with_each_other(rank_runs, world):
    """Every rank ends with the same loss, forward, gradients and params:
    the all-reduces hand each rank the same sums."""
    outs = rank_runs[world]
    for out in outs[1:]:
        for key in KEYS:
            for g, w in _pairs(out["fp32"], outs[0]["fp32"], key):
                assert np.array_equal(g, w), (world, key)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_the_references_shard_map(rank_runs, jax_ref, world):
    """fp32 on the ranks against the reference's 2x2 shard_map (4 fake
    devices): the tiled loss, the forward, the deferred step's loss and
    grads, and the params after 2 SGD steps of its trainer."""
    d = np.load(jax_ref)
    got = rank_runs[world][0]["fp32"]
    np.testing.assert_allclose(got["loss"], d["tloss"], **TOL)
    np.testing.assert_allclose(got["fwd"], d["fwd"], **TOL)
    np.testing.assert_allclose(got["dloss"], d["loss"], **TOL)
    for g, w in zip(got["grads"], _leaves(_tree(d, "g"))):
        np.testing.assert_allclose(g, w, **GRAD_TOL)
    for g, w in zip(got["params"], _leaves(_tree(d, "s"))):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_faults_fail_the_fp64_bar(rank_runs, fault):
    """Each fault moves the W = 4 deferred step's fp64 grads far past the
    bar the correct run meets (the loss reduced ahead of the backward also
    scales the loss by W)."""
    outs = rank_runs[4]
    want = outs[0]["virtual_fp64"]
    got = outs[0]["faults"][fault]
    err = max(_rel(g, w) for g, w in zip(got["grads"], want["grads"]))
    assert err > 1e6 * FP64_BAR, (fault, err)
    if fault == "loss_reduced_before_backward":
        assert float(got["dloss"]) == pytest.approx(4 * float(want["dloss"]), rel=1e-12)
        for g, w in zip(got["grads"], want["grads"]):
            np.testing.assert_allclose(g, 4 * w, rtol=1e-9, atol=1e-15)


def test_halo_bytes_equal_the_references_permutes(rank_runs, jax_ref):
    """A rank's collective-permute bytes over the fp32 deferred step (2
    microbatches) equal the reference's per device in the same compiled
    step: its permutes sit in the microbatch loop (trip count 2, which
    ``hlo.scan_trip_counts`` cannot read from this XLA's JSON form), and so
    do its 4 BN all-reduces a microbatch (each layer's two sums, combined
    by XLA as the port stacks them).  At batch end XLA's combiner merged the
    loss, count and gradient psums into one all-reduce; the port makes two
    (the gradients, and the loss sum and count in float64: 8 bytes more).
    ``halo_permute_bytes`` gives the same count from the plan."""
    d = np.load(jax_ref)
    assert d["hlo_scan_trip_counts"].size == 0
    assert int(d["collective-permute_trip"]) == 2 * int(d["collective-permute_count_in_loop"])
    params_bytes = sum(v.nbytes for k, v in d.items() if k.startswith("p") and k[1].isdigit())
    for out in rank_runs[4]:
        st = collective_stats(out["record"])
        assert st.count["collective-permute"] == int(d["collective-permute_count"]) == 24
        assert st.bytes_naive["collective-permute"] == int(d["collective-permute_bytes"])
        assert st.bytes_naive["collective-permute"] == 2 * halo_permute_bytes(
            _plan(), 2, (2, 2))
        assert st.count["all-reduce"] == int(d["all-reduce_count"]) + 1 == 10
        assert st.bytes_naive["all-reduce"] == int(d["all-reduce_bytes"]) + 8
        assert int(d["all-reduce_bytes"]) == 2 * 2 * 4 * 2 * (32 + 64) + params_bytes + 8


def test_launcher_on_two_ranks_gives_the_plain_launchers_loss(capsys):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --dist
    --device cpu`` (gloo, blocks of two tiles; only rank 0 prints) against
    the same flags on the virtual mesh in this process."""
    from repro_torch.launch.train import main

    flags = ["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "32", "--depth", "4",
             "--steps", "2", "--grid", "2", "--batch", "4", "--grad-accum", "2",
             "--optimizer", "sgd", "--groups", "2"]
    assert main(flags) == 0
    plain = capsys.readouterr().out
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *flags,
                          "--dist", "--dist-backend", "gloo"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    lines = run.stdout.splitlines()
    assert sum(ln.startswith("plan:") for ln in lines) == 1
    assert "dist=2 ranks=2x1 backend=gloo captured=False" in run.stdout

    def done(text):
        (line,) = [ln for ln in text.splitlines() if ln.startswith("done:")]
        return line.split("loss=")[1]          # loss=... gnorm=...

    assert done(run.stdout) == done(plain)


@pytest.mark.parametrize("flags,exc,match", [
    (["--dist", "--ckpt-dir", "ckpt"], ValueError, "A.20.2"),
    (["--dist", "--fault-schedule", "fail@1"], ValueError, "A.20.2"),
    (["--dist"], RuntimeError, "no torchrun environment"),
    (["--dist", "--arch", "qwen2-7b"], ValueError, "A.20.5"),
])
def test_launcher_refusals_under_dist(flags, exc, match, monkeypatch):
    from repro_torch.launch.train import main

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    base = ["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "32", "--depth", "4",
            "--steps", "1", "--grid", "2"]
    with pytest.raises(exc, match=match):
        main(base + flags)


OUTSIDE = {
    "non-uniform": lambda: tfu.build_stack_plan(HW, LAYERS, 2, 2, "auto", hw="pi3x3+jetson",
                                                batch=4, microbatches=2),
    "overlap": lambda: tfu.build_stack_plan(HW, LAYERS, 2, 2, [Group(0, 1), Group(2, 3)],
                                            schedule="overlap"),
    "crossover": lambda: tfu.build_stack_plan(HW, LAYERS, 2, 2, crossover=2),
    "pipeline": lambda: tfu.build_stack_plan((64, 64), yolov2_16_layers(batch_norm=False)[:8],
                                             2, 2, "auto", pipeline=2, hw="jetson-nano-gpu",
                                             batch=8, microbatches=2),
    "codec": lambda: tfu.build_stack_plan(HW, LAYERS, 2, 2, wire_codec="int8"),
}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_plans_outside_the_slice_name_their_item(name):
    """Every entry point refuses on ranks, before any collective, the plans
    the slice does not run: ROADMAP A.20.2."""
    group = TileGroup(0, 1, "gloo", torch.device("cpu"))
    mesh = make_dist_tile_mesh(2, 2, "cpu", group)
    plan = OUTSIDE[name]()
    for make in (lambda: tfu.make_tiled_forward(plan, mesh),
                 lambda: tfu.make_tiled_loss(plan, mesh, l2_loss_local),
                 lambda: tfu.make_deferred_grad_step(plan, mesh, l2_loss_local,
                                                     microbatches=2)):
        with pytest.raises(ValueError, match="A.20.2"):
            make()
    assert not group.record


def test_serve_engine_on_ranks_names_its_item():
    """The serve engine (its inference twin, captured on a card) on ranks
    is ROADMAP A.20.4; ``make_tiled_infer`` itself runs there."""
    from repro_torch.serve.cnn_engine import CNNServeEngine

    group = TileGroup(0, 1, "gloo", torch.device("cpu"))
    mesh = make_dist_tile_mesh(2, 2, "cpu", group)
    plan = _plan().inference_twin()
    tfu.make_tiled_infer(plan, mesh)
    with pytest.raises(ValueError, match="A.20.4"):
        CNNServeEngine(plan, mesh, None, buckets=(1,), step_bound=1.0)
