"""The wire codecs on ranks, alone and with the overlap schedule and a
crossover, against the virtual mesh and the JAX reference's ``shard_map``.

The slice of ``tests/test_torch_dist_plans.py`` (YOLOv2's first 4 layers at
32x32 on 2x2, groups (0-1)(2-3), 2 microbatches of 4 images) under
``wire_codec="int8"`` (the sync exchange, each rank encoding its own
tiles' strips and carrying its block's error-feedback residuals across the
microbatches) and under all three together (``schedule="overlap",
crossover=2, wire_codec="int8"``: the packed swap's payload, and the
compressed reshard - the payloads gathered along the rank rows and
columns, the backward's chunks EF-encoded per (sender, destination) pair
and exchanged all-to-all).  A codec plan is held to
``tests/test_torch_wire_codec.py``'s bar: normwise within ``CODEC_BAR``
times the codec's own effect (here the virtual mesh's codec run against its
run without the codec, in the same dtype), or the fp32 bar taken normwise
where that is larger (in fp64: ``FP64_BAR`` taken normwise, which the fp32
bar would hide a fault under); the grads of a plan whose only exchange is
the sync one within ``CARRY_BAR``, which a dropped EF carry fails:

- W = 1: the loss, the forward, the deferred grads and the params after 2
  SGD steps bitwise the virtual mesh's; at W = 2 and 4 ``make_tiled_infer``
  of the inference twin (BN frozen) bitwise too;
- W = 2 and W = 4 in fp64 within the codec bar of the virtual mesh, and
  ``wire_codec="topk:0.5"`` alone at W = 4 (the top-k indices ride the same
  exchanges);
- W = 4 in fp32 within the codec bar of the reference's codec run;
- W = 4: the residuals not carried to the second microbatch fail the bar;
- W = 4: each rank's ``collective-permute``, ``all-gather`` and
  ``all-to-all`` count and bytes (each payload leaf its own collective)
  equal the reference's compiled step's per device and
  ``analysis/collectives.py:plan_collectives``;
- the launcher under torchrun with 2 gloo ranks and ``--schedule overlap
  --crossover 2 --wire-codec int8`` gives the plain launcher's loss.
"""
import math
import os
import subprocess
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch.analysis.collectives import collective_stats, plan_collectives
from repro_torch.core import fusion as tfu
from repro_torch.core.halo import EFBag
from repro_torch.core.spatial import freeze_bn_stats
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_dist_tile_mesh, make_tile_mesh
from repro_torch.models.yolo import l2_loss_local
from repro_torch.parallel.dist import run_ranks
from test_torch_dist_plans import (
    FP64_BAR,
    MB,
    MICRO,
    REPO,
    leaves,
    plan_of,
    run_plan,
    start_jax_ref,
    tree_of,
    wait_jax_init,
    wait_jax_ref,
)

PLANS = {"int8": dict(wire_codec="int8"),
         "all": dict(schedule="overlap", crossover=2, wire_codec="int8")}
TOPK = dict(wire_codec="topk:0.5")
CODEC_BAR = 0.1                  # tests/test_torch_wire_codec.py:89
CARRY_BAR = 0.01                 # tests/test_torch_wire_codec.py:96, the sync plan's grads
FP32_ATOL, FP32_RTOL = 2e-5, 1e-4
KINDS = ("collective-permute", "all-gather", "all-to-all")
KEYS = ("loss", "fwd", "dloss", "grads", "params")


class DroppedCarry(EFBag):
    """The planted fault: every microbatch's residuals start from zero."""

    def take(self, shape, dtype=torch.float32, device=None):
        buf = super().take(shape, dtype, device)
        return torch.zeros_like(buf).requires_grad_(True) if self.mode == "buffers" else buf


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


def none_twin(kw):
    return {k: v for k, v in kw.items() if k != "wire_codec"}


def codec_scenario(group, ref_path, plans, fp32):
    """One rank: each codec plan on its block in fp64 (and in fp32 those
    named in ``fp32``), beside the virtual mesh's run of the plan and, on
    more than one rank, of its twin without the codec in the same dtype;
    the inference twin of each plan of ``PLANS`` on ranks and on the
    virtual mesh; the record of the fp32 deferred step; at W = 4 the int8
    plan's fp64 deferred grads with the carry dropped."""
    torch.set_num_threads(1)
    d = np.load(ref_path)
    mesh = make_dist_tile_mesh(2, 2, "cpu", group)
    virtual = make_tile_mesh(2, 2, "cpu")
    xs, ts = torch.from_numpy(d["xs"]), torch.from_numpy(d["ts"])
    params0 = params_from_jax(tree_of(d, "int8/p"), "cpu")       # the same seed-0 draw
    out = {"ranks": mesh.ranks, "plans": {}, "infer": {}}
    for name, kw in plans.items():
        plan, twin = plan_of(kw), plan_of(none_twin(kw))
        if name in PLANS:
            frozen = freeze_bn_stats(params0, plan.layers, xs[0])
            out["infer"][name] = [
                tfu.make_tiled_infer(plan.inference_twin(), m)(frozen, xs[1]).numpy()
                for m in (mesh, virtual)]
        record = Counter()
        got = {"record": record}
        for dtype, tag in ((torch.float32, "fp32"), (torch.float64, "fp64")):
            if tag == "fp32" and name not in fp32:
                continue
            got[tag] = run_plan(mesh, plan, params0, xs, ts, dtype,
                                record if tag == "fp32" else None)
            got[f"virtual_{tag}"] = run_plan(virtual, plan, params0, xs, ts, dtype)
            if group.world > 1:         # one rank is held bitwise, with no bar
                got[f"none_{tag}"] = run_plan(virtual, twin, params0, xs, ts, dtype)
        out["plans"][name] = got
    if group.world == 4:
        p64 = [{k: v.double() for k, v in p.items()} for p in params0]
        real, tfu.EFBag = tfu.EFBag, DroppedCarry
        try:
            step = tfu.make_deferred_grad_step(plan_of(PLANS["int8"]), mesh, l2_loss_local,
                                               microbatches=MICRO)
            _, grads = step(p64, xs.double(), ts.double())
        finally:
            tfu.EFBag = real
        out["dropped_carry"] = [g.numpy() for g in leaves(grads)]
    return out


@pytest.fixture(scope="module")
def rank_runs(jax_init):
    """W = 1, 2 and 4; ``topk:0.5`` in fp64 at W = 4 only, in the same
    processes."""
    return {w: run_ranks(codec_scenario, w, "cpu",
                         args=(jax_init, {**PLANS, "topk": TOPK} if w == 4 else PLANS,
                               () if w == 2 else tuple(PLANS)), timeout=600)
            for w in (1, 2, 4)}


def _norm(a):
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def within_codec_bar(got, codec, none, bar):
    """(err, bar): ||got - codec|| against max(bar ||codec - none||, the
    fp32 bar taken normwise) - ``tests/test_torch_wire_codec.py``'s
    ``_within_codec_bar`` - where ``got`` is fp32; in fp64 the floor is
    ``FP64_BAR`` x max(1, ||codec||)."""
    err = _norm(np.asarray(got, np.float64) - np.asarray(codec, np.float64))
    if np.asarray(got).dtype == np.float64:
        floor = FP64_BAR * max(1.0, _norm(codec))
    else:
        floor = FP32_ATOL * math.sqrt(max(1, np.size(codec))) + FP32_RTOL * _norm(codec)
    return err, max(bar * _norm(np.asarray(codec, np.float64) - none), floor)


def over_bar(name, got, codec, none):
    """The keys of ``got`` past the codec bar; a plan with only sync
    exchanges holds its grads to ``CARRY_BAR``."""
    sync_only = name in ("int8", "topk")
    over = {}
    for key in KEYS:
        g, c, z = got[key], codec[key], none[key]
        for i, (a, b, e) in enumerate(zip(g, c, z) if isinstance(g, list) else [(g, c, z)]):
            bar = CARRY_BAR if key == "grads" and sync_only else CODEC_BAR
            err, lim = within_codec_bar(a, b, e, bar)
            if err > lim:
                over[f"{key}{i}"] = (err, lim)
    return over


def test_launcher_on_two_ranks_with_every_option_gives_the_plain_launchers_loss(capsys):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --dist``
    with the overlap schedule, a crossover and int8 (gloo, blocks of two
    tiles; only rank 0 prints) against the same flags on the virtual mesh
    in this process.  First in the file: it needs neither the reference nor
    the ranks' runs, and runs while the reference compiles."""
    from repro_torch.launch.train import main

    flags = ["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "32", "--depth", "4",
             "--steps", "2", "--grid", "2", "--batch", "8", "--grad-accum", "2",
             "--optimizer", "sgd", "--groups", "2", "--schedule", "overlap", "--crossover", "2",
             "--wire-codec", "int8"]
    assert main(flags) == 0
    plain = capsys.readouterr().out
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *flags,
                          "--dist", "--dist-backend", "gloo"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "schedule=overlap grid=2x2 crossover=2" in run.stdout
    assert "wire_codec=int8" in run.stdout and "dist=2 ranks=2x1 backend=gloo" in run.stdout

    def done(text):
        (line,) = [ln for ln in text.splitlines() if ln.startswith("done:")]
        return line.split("loss=")[1]

    assert done(run.stdout) == done(plain)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_one_rank_is_bitwise_the_virtual_mesh(rank_runs, name):
    (out,) = rank_runs[1]
    got = out["plans"][name]
    for tag in ("fp32", "fp64"):
        for key in KEYS:
            g, w = got[tag][key], got[f"virtual_{tag}"][key]
            for a, b in (zip(g, w) if isinstance(g, list) else [(g, w)]):
                assert np.array_equal(a, b), (name, tag, key)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_codec_plans_on_ranks_match_the_virtual_mesh_in_fp64(rank_runs, name, world):
    for out in rank_runs[world]:
        got = out["plans"][name]
        over = over_bar(name, got["fp64"], got["virtual_fp64"], got["none_fp64"])
        assert not over, (name, world, over)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_tiled_infer_on_ranks_is_bitwise_the_virtual_mesh(rank_runs, name, world):
    """``make_tiled_infer`` of each plan's inference twin (BN frozen on a
    calibration batch, so no sum crosses ranks; strips compressed
    statelessly) gives every rank the virtual mesh's output bit for bit."""
    for out in rank_runs[world]:
        got, want = out["infer"][name]
        assert got.shape == want.shape and np.array_equal(got, want), (name, world)


def test_topk_on_four_ranks_matches_the_virtual_mesh_in_fp64(rank_runs):
    """``topk:0.5``: values and int32 indices of each tile's strip ride the
    exchanges as two payload leaves."""
    for out in rank_runs[4]:
        got = out["plans"]["topk"]
        over = over_bar("topk", got["fp64"], got["virtual_fp64"], got["none_fp64"])
        assert not over, over


@pytest.mark.parametrize("name", sorted(PLANS))
def test_codec_plans_on_ranks_match_the_references_codec_run(rank_runs, jax_ref, name):
    """fp32 on 4 ranks against the reference's 2x2 shard_map of the same
    codec plan: the tiled loss, the forward, the deferred step's loss and
    grads, the params after 2 SGD steps."""
    d = np.load(jax_ref)
    got = rank_runs[4][0]["plans"][name]
    ref = {"loss": d[f"{name}/tloss"], "fwd": d[f"{name}/fwd"], "dloss": d[f"{name}/loss"],
           "grads": leaves(tree_of(d, f"{name}/g")), "params": leaves(tree_of(d, f"{name}/s"))}
    over = over_bar(name, got["fp32"], ref, got["none_fp32"])
    assert not over, over


def test_a_dropped_ef_carry_fails_the_bar(rank_runs):
    """The int8 plan's deferred step with every microbatch's residuals
    starting from zero again fails the grad bar on 4 ranks, on every leaf
    upstream of the second group's exchange (the first group's)."""
    out = rank_runs[4][0]
    got = out["plans"]["int8"]
    over = []
    for i, (a, b, e) in enumerate(zip(out["dropped_carry"], got["virtual_fp64"]["grads"],
                                      got["none_fp64"]["grads"])):
        err, lim = within_codec_bar(a, b, e, CARRY_BAR)
        if err > lim:
            over.append(i)
    assert over == [0, 1, 2], over


@pytest.mark.parametrize("name", sorted(PLANS))
def test_collectives_equal_the_references_and_the_model(rank_runs, jax_ref, name):
    """Every rank's record of the fp32 deferred step: the permutes of each
    payload leaf (int8 codes, fp32 scales), the compressed reshard's
    gathers of each leaf and its backward's all-to-alls, count and bytes,
    equal the reference's compiled step per device and the model."""
    d = np.load(jax_ref)
    model = plan_collectives(plan_of(PLANS[name]), MB, (2, 2))
    for out in rank_runs[4]:
        st = collective_stats(out["plans"][name]["record"])
        for kind in KINDS:
            want = (int(d.get(f"{name}/{kind}_count", 0)), int(d.get(f"{name}/{kind}_bytes", 0)))
            got = (st.count.get(kind, 0), st.bytes_naive.get(kind, 0))
            assert got == want, (name, kind, got, want)
            assert got == tuple(MICRO * v for v in model.get(kind, (0, 0))), (name, kind, model)
    assert int(d["all/all-to-all_count"]) == int(d["all/all-gather_count"]) == 8
