"""Pipeline tails on ranks (``core/fusion.py:_make_pipeline_local`` over
``parallel/dist.py``) against the virtual mesh and the JAX reference's
``shard_map`` on 4 fake devices.

Two plans of ``tests/test_torch_pipeline_mode.py``, each with 2
microbatches of 4 images: ``prefix2x2`` (its 6 narrow layers at 16x16 on
2x2: a 2-layer spatial prefix, then 2 stages of a tile row each), and the
1x4, 2-stage plan of YOLOv2's first 6 layers without BN at 32x32 (no
prefix; stages of 2 tiles, so at W = 4 the hand-off hops 2 blocks), the
latter also under ``wire_codec="int8"`` (the hand-off's blocks encoded at
the reference's container, statelessly).  Every rank walks one tick
schedule: the prefix and the entry's two gathers at stage 0's slots, the
hand-offs between the ranks holding the sending and the receiving
stage's tiles, each stage's layers on the ranks holding its tiles; the
backward walks it in reverse (the hand-offs' cotangents sent back
explicitly, the gathers' reduce-scatters on every rank).  CPU ranks run
gloo, one intra-op thread each, one spawn of ranks per world size:

- W = 1: the tiled loss (M = 1) and its gradients, the deferred step's
  loss and gradients and the params after 2 SGD steps bitwise the virtual
  mesh (which runs the same schedule);
- W = 2 and 4: the same in fp64 within ``FP64_BAR`` of the virtual mesh
  (int8: the codec bar, its none twin the uncompressed plan);
- W = 4 in fp32 against the reference's ``shard_map``: the tiled loss and
  the deferred step's loss and grads within ``tests/test_kernels.py:23``'s
  tolerances (grads: its ``:201``), int8 within the codec bar;
- W = 4: planted faults fail the fp64 bar - the 2-block hop delivered to
  the neighbour block, the stage gradients not all-reduced;
- W = 4: every rank's record equals ``plan_collectives`` (the prefix's
  permutes, the entry's gathers and reduce-scatters, the hand-offs).  The
  entry's gathers equal the reference's per pass, each of the same bytes:
  the reference runs them at each of its M + S - 1 ticks, the port once a
  microbatch.  Its hand-offs differ by design: the reference
  ``ppermute``s one container-size buffer on every device at each tick
  (and the transpose in its backward), a rank here one hand-off per
  microbatch and stage boundary where it holds tiles of the sending
  stage, at the blocks' true extents (and one back where it holds the
  receiving stage's);
- the launcher under torchrun with 2 gloo ranks and ``--pipeline 2``
  gives the plain launcher's loss.
"""
import dataclasses
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.analysis.collectives import collective_stats, plan_collectives
from repro_torch.core import fusion as tfu
from repro_torch.core import spatial as tsp
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_dist_tile_mesh, make_tile_mesh
from repro_torch.models.yolo import l2_loss_local
from repro_torch.parallel import dist as tdist
from repro_torch.parallel.dist import run_ranks
from test_torch_dist_ragged import (
    FP64_BAR,
    GRAD_TOL,
    REPO,
    TOL,
    layers_of,
    leaves,
    over_codec_bar,
    pairs,
    plan_of,
    rel,
    run_plan,
    runs_of,
    start_jax_ref,
    tree_of,
    wait_jax_init,
    wait_jax_ref,
)

LAYERS6 = [tsp.LayerDef(3, 1, 3, 8, act="leaky"), tsp.LayerDef(3, 2, 8, 8, act="leaky"),
           tsp.LayerDef(3, 1, 8, 16, act="leaky"), tsp.LayerDef(3, 1, 16, 16, act="leaky"),
           tsp.LayerDef(3, 1, 16, 16, act="leaky"), tsp.LayerDef(1, 1, 16, 8, act="leaky")]
PURE = dict(stack="yolo_nobn", depth=6, hw=[32, 32], grid=[1, 4],
            groups=[(0, 3, "pipeline"), (4, 5, "pipeline")], micro=2, mb=4, kw={})
PLANS = {
    "prefix2x2": dict(stack=[dataclasses.asdict(l) for l in LAYERS6], depth=6, hw=[16, 16],
                      grid=[2, 2], groups=[(0, 1, "spatial"), (2, 3, "pipeline"),
                                           (4, 5, "pipeline")], micro=2, mb=4, kw={}),
    "pure1x4": PURE,
    "pure1x4_int8": dict(PURE, kw=dict(wire_codec="int8")),
}
NONE_TWIN = {"pure1x4_int8": "pure1x4"}
FAULTS = {"two_block_hop_to_the_neighbour_block": "pure1x4",
          "stage_grads_not_all_reduced": "prefix2x2"}
KEYS = ("loss", "dloss", "grads", "params")


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


def plant(fault):
    """Patch this rank's process with ``fault``; -> a function that undoes
    it."""
    if fault == "two_block_hop_to_the_neighbour_block":
        real = tdist._hop_start

        def one_block_short(x, dim, shift, mesh, span, tag):
            # every rank plans the same short hop, so its messages still pair
            b = x.shape[dim]
            if abs(shift) > b:
                shift -= b if shift > 0 else -b
            return real(x, dim, shift, mesh, span, tag)

        tdist._hop_start = one_block_short
        return lambda: setattr(tdist, "_hop_start", real)
    if fault == "stage_grads_not_all_reduced":
        real = tfu.all_reduce_
        # the grads' list is left per rank; the loss sum and count (one
        # tensor) still cross
        tfu.all_reduce_ = lambda group, ts: ts if len(ts) > 1 else real(group, ts)
        return lambda: setattr(tfu, "all_reduce_", real)
    raise ValueError(fault)


def scenario(group, ref_path, plans, faults):
    """One rank: each plan on its block (``runs_of``) and the virtual mesh
    beside it, the tiled loss's gradients too, the record of the fp32
    deferred step, and the fp64 deferred grads under each planted fault."""
    torch.set_num_threads(1)
    d = np.load(ref_path)
    out = {"plans": {}, "faults": {}}
    for name, spec in plans.items():
        plan = plan_of(spec)
        mesh = make_dist_tile_mesh(*spec["grid"], "cpu", group)
        virtual = make_tile_mesh(*spec["grid"], "cpu")
        got = {"ranks": mesh.ranks, "coord": mesh.coord, "record": Counter()}
        for tag, with_virtual in runs_of(group):
            dtype = {"fp32": torch.float32, "fp64": torch.float64}[tag]
            for m, key in ((mesh, tag),) + (((virtual, f"virtual_{tag}"),) if with_virtual else ()):
                rec = got["record"] if m is mesh and tag == "fp32" else None
                got[key] = run_plan(m, plan, spec, d, name, dtype, rec)
                params = [{k: v.to(dtype).requires_grad_(True) for k, v in p.items()}
                          for p in params_from_jax(tree_of(d, f"{name}/p", len(plan.layers)),
                                                   "cpu")]
                loss = tfu.make_tiled_loss(plan, m, l2_loss_local)(
                    params, torch.from_numpy(d[f"{name}/xs"][0]).to(dtype),
                    torch.from_numpy(d[f"{name}/ts"][0]).to(dtype))
                got[key]["loss_grads"] = [g.numpy() for g in
                                          torch.autograd.grad(loss, leaves(params))]
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


ALL_KEYS = KEYS + ("loss_grads",)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_one_rank_is_bitwise_the_virtual_mesh(rank_runs, name):
    """W = 1: the whole grid on one rank walks the virtual mesh's schedule
    (its hand-offs move within the block, its gathers span one rank)."""
    (out,) = rank_runs[1]
    got = out["plans"][name]
    assert got["ranks"] == (1, 1)
    for tag in ("fp32", "fp64"):
        for key in ALL_KEYS:
            for g, w in pairs(got[tag], got[f"virtual_{tag}"], key):
                assert np.array_equal(g, w), (name, tag, key)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranks_match_the_virtual_mesh_in_fp64(rank_runs, name, world):
    outs = rank_runs[world]
    want_ranks = {2: {(2, 2): (2, 1), (1, 4): (1, 2)}, 4: {(2, 2): (2, 2), (1, 4): (1, 4)}}
    want = outs[0]["plans"][name]["virtual_fp64"]
    for out in outs:
        got = out["plans"][name]
        assert got["ranks"] == want_ranks[world][tuple(PLANS[name]["grid"])]
        if name in NONE_TWIN:
            none = outs[0]["plans"][NONE_TWIN[name]]["virtual_fp64"]
            over = over_codec_bar(got["fp64"], want, none, ALL_KEYS)
            assert not over, (name, world, over)
            continue
        for key in ALL_KEYS:
            for g, w in pairs(got["fp64"], want, key):
                assert rel(g, w) <= FP64_BAR, (name, world, key, rel(g, w))


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranks_agree_with_each_other(rank_runs, name):
    outs = rank_runs[4]
    for out in outs[1:]:
        for key in ALL_KEYS:
            for g, w in pairs(out["plans"][name]["fp32"], outs[0]["plans"][name]["fp32"], key):
                assert np.array_equal(g, w), (name, key)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_ranks_match_the_references_shard_map(rank_runs, jax_ref, name):
    """fp32 on 4 ranks against the reference's staged plan on its 2x2 or
    1x4 mesh: the tiled loss, the deferred step's loss and grads."""
    d = np.load(jax_ref)
    got = rank_runs[4][0]["plans"][name]["fp32"]
    ref = {"loss": d[f"{name}/loss"], "dloss": d[f"{name}/dloss"],
           "grads": leaves(tree_of(d, f"{name}/g", len(layers_of(PLANS[name]))))}
    if name in NONE_TWIN:
        none = rank_runs[4][0]["plans"][NONE_TWIN[name]]["fp32"]
        over = over_codec_bar(got, ref, none, tuple(ref))
        assert not over, over
        return
    for key in ("loss", "dloss"):
        np.testing.assert_allclose(got[key], ref[key], **TOL, err_msg=key)
    for g, w in zip(got["grads"], ref["grads"]):
        np.testing.assert_allclose(g, w, **GRAD_TOL)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_faults_fail_the_fp64_bar(rank_runs, fault):
    """Each fault moves the W = 4 deferred step's fp64 grads far past the
    bar the correct run meets: stage 0's tiles handed one block on (to
    stage 0's second tile and stage 1's first) instead of two, and each
    rank's stage gradients left its own."""
    want = rank_runs[4][0]["plans"][FAULTS[fault]]["virtual_fp64"]["grads"]
    for out in rank_runs[4]:
        err = max(rel(g, w) for g, w in zip(out["faults"][fault], want))
        assert err > 1e6 * FP64_BAR, (fault, err)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_collectives_equal_the_model_and_the_entry_gathers_the_references(rank_runs, jax_ref,
                                                                          name):
    """Every rank's record of the fp32 deferred step (2 microbatches)
    equals ``plan_collectives`` at its coordinates: a rank of stage 0 sends
    one hand-off a microbatch and takes one cotangent back, a rank of the
    last stage the reverse.  The entry's all-gathers and reduce-scatters
    (prefix2x2's) equal the reference's per pass, count and bytes: the
    reference's at each tick, the port's once a microbatch."""
    d = np.load(jax_ref)
    spec = PLANS[name]
    plan = plan_of(spec)
    ticks = spec["micro"] + plan.n_stages - 1
    for out in rank_runs[4]:
        got_plan = out["plans"][name]
        model = plan_collectives(plan, spec["mb"], got_plan["ranks"], got_plan["coord"])
        st = collective_stats(got_plan["record"])
        got = {k: [st.count[k], st.bytes_naive[k]] for k in st.count if k != "all-reduce"}
        assert got == {k: [spec["micro"] * c, spec["micro"] * b] for k, (c, b) in model.items()}
        for kind in ("all-gather", "reduce-scatter"):
            # per pass: the reference's count and bytes over its ticks, the
            # port's over its microbatches (pure1x4 has no prefix: the port
            # gathers nothing, its inputs being whole on every rank)
            want = [int(d.get(f"{name}/{kind}_{x}", 0)) * spec["micro"] for x in ("count", "bytes")]
            have = [v * ticks for v in got.get(kind, [0, 0])]
            assert have == (want if plan.pipeline_first else [0, 0]), (name, kind, have, want)


def test_launcher_on_two_ranks_runs_a_pipeline_and_gives_the_plain_launchers_loss(capsys):
    """``torchrun --nproc-per-node 2 ... --pipeline 2 --dist`` (gloo, a
    stage a rank): one plan line with the stages, and the plain launcher's
    loss and gradient norm."""
    from repro_torch.launch.train import main

    flags = ["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "64", "--depth", "8",
             "--grid", "2", "--groups", "auto", "--hw-profile", "jetson-nano-gpu", "--pipeline",
             "2", "--no-batch-norm", "--batch", "8", "--grad-accum", "2", "--steps", "2",
             "--optimizer", "sgd"]
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
    assert "stages=((0, 2), (2, 4))" in run.stdout and "dist=2 ranks=2x1" in run.stdout

    def done(text):
        (line,) = [ln for ln in text.splitlines() if ln.startswith("done:")]
        return line.split("loss=")[1]

    assert done(run.stdout) == done(plain)
