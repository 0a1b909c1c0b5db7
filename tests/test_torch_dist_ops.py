"""The collectives of ``parallel/dist.py`` on CPU ranks (gloo), against the
virtual mesh's ops, and their rules.

- ``permute_start`` of every rank's block against ``core/halo.py:_shift`` of the
  whole grid, and ``all_reduce_sum`` against the plain sum over the
  blocks, in fp64, at W = 2 and W = 4 over 2x2, 4x2 and 4x4 grids (blocks of
  one, two and four tiles), by shifts of one tile and of a whole block;
  each spawn of ranks also runs ``torch.autograd.gradcheck`` through them
  (the input replicated on every rank, the outputs gathered: see
  ``_Gathered``).
- The record of every collective and ``analysis/collectives.py``'s stats
  against the reference's ring model (``repro/analysis/hlo.py``).
- The rules: the rank grid, the backend rule (no silent fallback), a rank
  that fails, the swaps and shifts that are refused.

One spawn of ranks per scenario, one intra-op thread a rank.
"""
import os
from collections import Counter

import numpy as np
import pytest
import torch

from repro.analysis import hlo as jhlo
from repro_torch.analysis.collectives import collective_stats
from repro_torch.core.halo import _shift
from repro_torch.launch.mesh import make_dist_tile_mesh
from repro_torch.parallel import dist as tdist
from repro_torch.parallel.dist import (
    Collective,
    TileGroup,
    all_gather_blocks,
    all_reduce_sum,
    permute_start,
    rank_grid,
    replicated,
    resolve_backend,
    run_ranks,
)

GRIDS = {2: [(2, 2), (4, 2)], 4: [(2, 2), (4, 4)]}
BLOCK = (1, 3, 2, 2)           # (B, h, w, C) of every tile


class _Gathered(torch.autograd.Function):
    """Every rank's ``x`` stacked in rank order, the same on every rank;
    the backward takes this rank's slice of the (replicated) cotangent.
    With the input ``replicated`` too, each rank's function is the global
    one, so gradcheck's perturbations, made alike on every rank, probe it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rank = group.rank
        return torch.stack(all_gather_blocks(group, x.contiguous()))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank], None


def _block_of(mesh, x):
    (r0, c0), (bn, bm) = mesh.origin, mesh.block
    return x[r0:r0 + bn, c0:c0 + bm]


def _ops_rank(group, grids):
    """Per grid: the largest error of every permute and of the all-reduce
    against the virtual ops, the gradcheck outcomes and the record."""
    torch.set_num_threads(1)
    out = []
    for n, m in grids:
        mesh = make_dist_tile_mesh(n, m, "cpu", group)
        gen = torch.Generator().manual_seed(n * 10 + m)
        x = torch.randn((n, m, *BLOCK), generator=gen, dtype=torch.float64)
        errs = {}
        for dim in (0, 1):
            b = mesh.block[dim]
            for shift in sorted({1, -1, b, -b, 2 * b, -2 * b, b + 1, -(b + 1)}):
                got = permute_start(_block_of(mesh, x), dim, shift, mesh).wait()
                want = _block_of(mesh, _shift(x, dim, shift))
                errs[f"permute d{dim} s{shift}"] = float((got - want).abs().max())
            # one stage's senders: the grid's first half along dim, by its size
            half = x.shape[dim] // 2
            got = permute_start(_block_of(mesh, x), dim, half, mesh, span=(0, half)).wait()
            stage = torch.cat([x.narrow(dim, 0, half), torch.zeros_like(x.narrow(dim, 0, half))],
                              dim)
            want = _block_of(mesh, _shift(stage, dim, half))
            errs[f"permute d{dim} span s{half}"] = float((got - want).abs().max())
        (bn, bm), (rr, rc) = mesh.block, mesh.ranks
        blocks = [x[r * bn:(r + 1) * bn, c * bm:(c + 1) * bm] for r in range(rr) for c in range(rc)]
        errs["all_reduce_sum"] = float((all_reduce_sum(_block_of(mesh, x), group)
                                        - sum(blocks)).abs().max())
        group.take_record()
        permute_start(_block_of(mesh, x), 0, 1, mesh).wait()
        record = group.take_record()
        # gradcheck on a smaller grid input: every rank perturbs the same
        # element of the replicated input, and gathers every rank's output
        xs = x[..., :1, :1, :1].clone().requires_grad_(True)
        weight = torch.arange(1.0, 1.0 + xs[:mesh.block[0], :mesh.block[1]].numel(),
                              dtype=torch.float64).reshape(xs[:mesh.block[0], :mesh.block[1]].shape)
        checks = {}
        for dim in (0, 1):
            for shift, span in ((1, None), (x.shape[dim] // 2, (0, x.shape[dim] // 2))):
                checks[f"permute d{dim} s{shift}"] = torch.autograd.gradcheck(
                    lambda t, dim=dim, shift=shift, span=span: _Gathered.apply(
                        permute_start(_block_of(mesh, replicated(t, group)), dim, shift, mesh,
                                      span=span).wait(),
                        group),
                    (xs,), eps=1e-6, atol=1e-8)
        checks["all_reduce_sum"] = torch.autograd.gradcheck(
            lambda t: _Gathered.apply(
                all_reduce_sum(_block_of(mesh, replicated(t, group)), group)
                * (weight * (group.rank + 1)), group),
            (xs,), eps=1e-6, atol=1e-8)
        out.append(dict(grid=(n, m), ranks=mesh.ranks, coord=mesh.coord, errs=errs,
                        checks=checks, record=record))
    return out


@pytest.fixture(scope="module", params=[2, 4])
def ops_run(request):
    world = request.param
    return world, run_ranks(_ops_rank, world, "cpu", args=(GRIDS[world],), timeout=300)


def test_permute_and_all_reduce_match_the_virtual_ops_in_fp64(ops_run):
    """Each rank's permuted block equals its block of the zero-filled shift
    of the whole grid (data movement: exactly), by one tile and by a whole
    block, both directions, both tile dimensions; the all-reduce equals
    the sum of the blocks."""
    world, outs = ops_run
    assert len(outs) == world
    for per_rank in outs:
        for g in per_rank:
            assert g["ranks"] == rank_grid(*g["grid"], world)
            for what, err in g["errs"].items():
                assert err <= (1e-15 if what == "all_reduce_sum" else 0.0), (g["grid"], what, err)


def test_permute_and_all_reduce_pass_gradcheck_across_ranks(ops_run):
    """``torch.autograd.gradcheck`` of the replicated input through the
    permute (its backward: the reverse permute) and through the all-reduce
    (its backward: the all-reduced cotangent), outputs gathered, on every
    rank."""
    _, outs = ops_run
    assert all(ok for per_rank in outs for g in per_rank for ok in g["checks"].values())


def test_record_holds_each_permute_with_its_strip_and_sender(ops_run):
    """A permute by one tile along the rows records the strip it moves (one
    row of tiles of the block) once on every rank, edge ranks too: the
    reference counts a permute's payload on every device."""
    world, outs = ops_run
    for per_rank in outs:
        for g in per_rank:
            n, m = g["grid"]
            rc = g["ranks"][1]
            strip = (m // rc) * int(np.prod(BLOCK)) * 8
            assert g["record"] == {Collective("collective-permute", strip, 2): 1}


def _failing_rank(group):
    if group.rank == 1:
        raise ArithmeticError("planted failure on rank 1")
    return group.rank


def test_run_ranks_raises_a_failed_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*planted failure on rank 1"):
        run_ranks(_failing_rank, 2, "cpu", timeout=120)


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the default device where no card is")
def test_run_ranks_runs_on_the_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="rank 0 failed(.|\n)*pass device='cpu'"):
        run_ranks(_failing_rank, 1, timeout=120)


def _exiting_rank(group):
    if group.rank == 1:
        os._exit(3)
    return group.rank


def test_run_ranks_raises_when_a_rank_dies_without_a_result():
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3 and no result"):
        run_ranks(_exiting_rank, 2, "cpu", timeout=120)


@pytest.mark.parametrize("kind,out_bytes,g", [
    ("all-reduce", 4096, 4), ("all-gather", 4096, 4), ("collective-permute", 640, 2),
    ("all-reduce", 4096, 1), ("reduce-scatter", 1024, 4), ("all-to-all", 1024, 4),
])
def test_collective_stats_use_the_references_ring_model(kind, out_bytes, g):
    rec = Counter({Collective(kind, out_bytes, g): 2, Collective(kind, 2 * out_bytes, g): 1})
    st = collective_stats(rec)
    assert st.count == {kind: 3} and st.bytes_naive == {kind: 4 * out_bytes}
    assert st.bytes_ring[kind] == pytest.approx(2 * jhlo._ring_bytes(kind, out_bytes, g)
                                                + jhlo._ring_bytes(kind, 2 * out_bytes, g))
    assert st.total_naive == 4 * out_bytes
    assert st.per_op == [(kind, out_bytes, g, 2), (kind, 2 * out_bytes, g, 1)]


@pytest.mark.parametrize("n,m,world,want", [
    (2, 2, 1, (1, 1)), (2, 2, 2, (2, 1)), (2, 2, 4, (2, 2)), (4, 2, 2, (2, 1)),
    (4, 4, 8, (4, 2)), (1, 4, 2, (1, 2)), (3, 3, 9, (3, 3)),
])
def test_rank_grid_takes_the_squarest_equal_blocks(n, m, world, want):
    assert rank_grid(n, m, world) == want


@pytest.mark.parametrize("n,m,world", [(2, 2, 3), (2, 2, 8), (3, 3, 2)])
def test_rank_grid_refuses_unequal_blocks(n, m, world):
    with pytest.raises(ValueError, match="do not split"):
        rank_grid(n, m, world)


@pytest.mark.parametrize("device,backend,local_world,cards,want", [
    ("cpu", None, 4, 0, "gloo"),
    ("cuda", None, 1, 1, "nccl"),
    ("cuda", None, 4, 4, "nccl"),
    ("cuda", "gloo", 4, 1, "gloo"),
])
def test_backend_rule_defaults_and_named_gloo(device, backend, local_world, cards, want):
    assert resolve_backend(device, backend, local_world, cards) == want


@pytest.mark.parametrize("device,backend,local_world,cards,match", [
    ("cuda", None, 4, 1, "one rank a card"),
    ("cuda", "nccl", 2, 1, "one rank a card"),
    ("cpu", "nccl", 1, 0, "CUDA tensors only"),
    ("cpu", "mpi", 1, 0, "one of"),
])
def test_backend_rule_has_no_silent_fallback(device, backend, local_world, cards, match):
    with pytest.raises(ValueError, match=match):
        resolve_backend(device, backend, local_world, cards)


def test_permute_refuses_what_the_slice_does_not_run():
    """A swap along an axis of other than two tiles and a shift by 0 are
    refused before any collective.  A hop past the neighbour block (a
    pipeline hand-off) runs: on one rank it is the virtual shift, the
    tiles past the grid's edge recorded as leaving, as every device of
    the reference runs its ``ppermute``.  (The overlap schedule's swap of
    a 2-tile axis runs on ranks: ``tests/test_torch_dist_plans.py``.)"""
    group = TileGroup(0, 1, "gloo", torch.device("cpu"))
    mesh = make_dist_tile_mesh(4, 2, "cpu", group)
    x = torch.arange(32.0).reshape(4, 2, 1, 2, 2, 1)
    with pytest.raises(ValueError, match="2-tile axis"):
        permute_start(x, 0, "swap", mesh)
    with pytest.raises(ValueError, match="by 0 tiles"):
        permute_start(x, 1, 0, mesh)
    assert not group.record
    assert torch.equal(permute_start(x, 1, 3, mesh).wait(), _shift(x, 1, 3))
    assert torch.equal(permute_start(x, 0, 3, mesh).wait(), _shift(x, 0, 3))
    tile = 4 * 4                               # bytes of one tile's (1, 2, 2, 1) fp32
    assert group.take_record() == Counter({Collective("collective-permute", 8 * tile, 2): 1,
                                           Collective("collective-permute", 6 * tile, 2): 1})
    # a stage's hop that stays in the block crosses nothing and records nothing
    assert torch.equal(permute_start(x, 0, 2, mesh, span=(0, 2)).wait(),
                       _shift(torch.cat([x[:2], torch.zeros_like(x[:2])]), 0, 2))
    assert not group.record


def test_mesh_block_neighbours_and_device():
    """Rank 1 of 4 over a 4x4 grid holds the 2x2 block at tile (0, 2); its
    neighbours are ranks 3 below and 0 to the left; a mesh on another
    device than its group's raises."""
    group = TileGroup(1, 4, "gloo", torch.device("cpu"))
    mesh = make_dist_tile_mesh(4, 4, "cpu", group)
    assert (mesh.ranks, mesh.coord, mesh.block, mesh.origin) == ((2, 2), (0, 1), (2, 2), (0, 2))
    assert [mesh.neighbour(0, 1), mesh.neighbour(0, -1), mesh.neighbour(1, 1),
            mesh.neighbour(1, -1)] == [3, None, None, 0]
    x = torch.arange(2 * 8 * 8 * 1, dtype=torch.float32).reshape(2, 8, 8, 1)
    assert torch.equal(mesh.split(x), make_dist_tile_mesh(4, 4, "cpu", TileGroup(
        0, 1, "gloo", torch.device("cpu"))).split(x)[0:2, 2:4])
    with pytest.raises(ValueError, match="not the group's"):
        make_dist_tile_mesh(2, 2, "meta", group)


def test_init_tile_group_needs_torchrun_environment(monkeypatch):
    for k in tdist.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no torchrun environment"):
        tdist.init_tile_group("cpu")
