"""The port's non-uniform tile partitions (DESIGN.md §8-9) against the JAX
reference.

- packing: ``TileMesh.split`` / ``merge`` with the partition's rows and
  columns equal, bit for bit, to the reference's ``_pack_grid`` /
  ``_unpack_grid`` under a uniform split;
- exchanges: ``halo_exchange_2d_ragged`` (zero pad slots) and
  ``halo_exchange_2d_spec`` (garbage pad slots, never read) equal, bit for
  bit, to the reference's inside ``shard_map`` on 1x2, 2x2 and 3x3 meshes
  with ragged sizes (a subprocess with 9 fake devices);
- executors: the forward, the loss and the microbatched deferred step of
  ``ragged_exec="spec"`` and ``"padded"`` against JAX's ragged plans on its
  2x2 mesh (a subprocess with 4 fake devices), and the loss and gradients
  against the untiled reference at ``scripts/check_pipeline.py``'s bars
  (loss rel 1e-5, grads 1e-4 max |diff| - or twice the untiled fp32
  reference's own distance from fp64 where that is larger, see
  ``GRAD_FLOOR_FACTOR``; forward 1e-4, the bar of
  ``scripts/check_overlap.py:90``), on a 7x7 single conv, the 34x34 YOLO-4
  stack, ``pi3x3+jetson`` at 64x64 with depth 8 and its crossover twin; in
  fp64 both executors equal the untiled fp64 reference to rounding;
- the planner: the 416 plans of ``chip_smoke.py``'s phase 14 equal the
  reference's, an explicit even partition is today's uniform plan on
  today's path, a ragged plan under ``schedule="overlap"`` runs the sync
  exchange, spec and padded plans key the serve cache apart;
- a tied max pool sends its gradient to the first maximum, as the
  reference's ``select_and_scatter`` does;
- ``chip_smoke.py``'s ``conv_shapes`` - the launch count it holds the card
  to - lists the ragged executors' conv calls.
"""
import dataclasses
import importlib.util
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
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
from repro_torch.core.backend import _torch_conv, register_conv_backend
from repro_torch.core.halo import halo_exchange_2d_ragged, halo_exchange_2d_spec
from repro_torch.core.tiling import Group, TilePartition
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_tile_mesh, pack_grid
from repro_torch.models.yolo import l2_loss_local, yolov2_16_layers
from repro_torch.serve.cnn_engine import CNNServeEngine, ManualClock
from repro_torch.serve.exec_cache import plan_cache_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scripts/check_pipeline.py:348-372 (loss, grads); scripts/check_overlap.py:90 (forward)
LOSS_RTOL, GRAD_ATOL, FWD_ATOL = 1e-5, 1e-4, 1e-4
FP64_ATOL = 1e-12
# Where fp32 itself cannot resolve GRAD_ATOL - a 2x2 max-pool window whose
# two largest values are closer than fp32's rounding sends the gradient to
# another element than fp64 does, in the untiled fp32 reference as in any
# tiled run - a leaf is held within this factor of the untiled fp32
# reference's own distance from fp64 instead (chip_smoke.py's
# GRAD_FLOOR_FACTOR rule).  The fp64 test holds every executor exact.
GRAD_FLOOR_FACTOR = 2.0
EXECS = ["spec", "padded"]


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
    return tuple(hw)


def _leaves(params):
    return [v for p in params for v in p.values()]


def _run(script: str, args, devices: int) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", script, *map(str, args)], env=env, check=True,
                   timeout=600)


def _tiles_of(global_arr, n, m):
    """(B, n*h, m*w, C) -> (n, m, B, h, w, C): a uniform split, the device
    blocks of a ``P(None, row, col, None)`` array."""
    b, gh, gw, c = global_arr.shape
    return global_arr.reshape(b, n, gh // n, m, gw // m, c).transpose(1, 3, 0, 2, 4, 5)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

PARTITIONS = [((4, 3), (4, 3)), ((16, 48), (32, 32)), ((24, 24, 16), (24, 24, 16)),
              ((1, 7), (2, 6)), ((5,), (6, 4)), ((9, 9, 8), (3, 9, 9))]


@pytest.mark.parametrize("rows,cols", PARTITIONS)
def test_split_and_merge_are_the_references_pack_grid(rows, cols):
    x = np.random.default_rng(len(rows) + sum(cols)).standard_normal(
        (2, sum(rows), sum(cols), 3)).astype(np.float32)
    mesh = make_tile_mesh(len(rows), len(cols), "cpu")
    tiles = mesh.split(torch.from_numpy(x), rows, cols)
    packed = np.asarray(jfu._pack_grid(jnp.asarray(x), rows, cols))
    np.testing.assert_array_equal(tiles.numpy(), _tiles_of(packed, len(rows), len(cols)))
    np.testing.assert_array_equal(pack_grid(torch.from_numpy(x), rows, cols).numpy(), packed)
    merged = mesh.merge(tiles, rows, cols)
    np.testing.assert_array_equal(merged.numpy(),
                                  np.asarray(jfu._unpack_grid(jnp.asarray(packed), rows, cols)))
    np.testing.assert_array_equal(merged.numpy(), x)


def test_uniform_split_is_unchanged():
    x = torch.randn(2, 8, 6, 3, generator=torch.Generator().manual_seed(0))
    mesh = make_tile_mesh(2, 3, "cpu")
    assert torch.equal(mesh.split(x, (4, 4), (2, 2, 2)), mesh.split(x))
    assert torch.equal(mesh.merge(mesh.split(x), (4, 4), (2, 2, 2)), x)


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

EXCHANGE_MESHES = {(1, 2): ((5,), (6, 4)), (2, 2): ((5, 3), (4, 6)),
                   (3, 3): ((4, 4, 3), (2, 5, 4))}
EXCHANGE_HALOS = [(1, 1, 1, 1), (2, 1, 0, 2), (0, 0, 1, 2), (0, 0, 0, 0), (1, 2, 2, 0)]

_JAX_EXCHANGE = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core.halo import halo_exchange_2d_ragged, halo_exchange_2d_spec
    MESHES, HALOS = %r, %r
    out = {}
    for (n, m), (rows, cols) in MESHES.items():
        mesh = Mesh(np.array(jax.devices()[:n * m]).reshape(n, m), ("th", "tw"))
        hmax, wmax = max(rows), max(cols)
        rng = np.random.default_rng(n * 10 + m)
        x = rng.standard_normal((2, n * hmax, m * wmax, 3)).astype(np.float32)
        valid = np.zeros((n * hmax, m * wmax), bool)
        for i, r in enumerate(rows):
            for j, c in enumerate(cols):
                valid[i * hmax:i * hmax + r, j * wmax:j * wmax + c] = True
        x0 = np.where(valid[None, :, :, None], x, 0).astype(np.float32)
        out[f"{n}x{m}/x"], out[f"{n}x{m}/x0"] = x, x0
        spec = P(None, "th", "tw", None)
        for halo in HALOS:
            top, bottom, left, right = halo
            for wide in (0, 1):
                oe = (hmax + top + bottom + wide, wmax + left + right + 2 * wide) if wide else None
                def f(a, b):
                    return (halo_exchange_2d_ragged(a, halo, "th", "tw", rows, cols, dims=(1, 2),
                                                    out_extents=oe),
                            halo_exchange_2d_spec(b, halo, "th", "tw", rows, cols, dims=(1, 2),
                                                  out_extents=oe))
                got = jax.jit(shard_map(f, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                                        check_rep=False))(x0, x)
                key = f"{n}x{m}/{'_'.join(map(str, halo))}/{wide}"
                out[key + "/ragged"], out[key + "/spec"] = map(np.asarray, got)
    np.savez(sys.argv[1], **out)
""") % ({k: v for k, v in EXCHANGE_MESHES.items()}, EXCHANGE_HALOS)


@pytest.fixture(scope="module")
def jax_exchange(tmp_path_factory):
    out = tmp_path_factory.mktemp("exchange") / "exchange.npz"
    _run(_JAX_EXCHANGE, [out], 9)
    return dict(np.load(out))


@pytest.mark.parametrize("wide", [0, 1])
@pytest.mark.parametrize("halo", EXCHANGE_HALOS)
@pytest.mark.parametrize("grid", sorted(EXCHANGE_MESHES))
def test_ragged_and_spec_exchanges_equal_the_reference(jax_exchange, grid, halo, wide):
    """Both exchanges bit for bit: the padded one on tiles whose pad slots
    are zero (and stay zero), the spec one on tiles whose pad slots hold
    garbage it must not read."""
    n, m = grid
    rows, cols = EXCHANGE_MESHES[grid]
    top, bottom, left, right = halo
    oe = ((max(rows) + top + bottom + wide, max(cols) + left + right + 2 * wide)
          if wide else None)
    key = f"{n}x{m}/{'_'.join(map(str, halo))}/{wide}"
    x0 = torch.from_numpy(_tiles_of(jax_exchange[f"{n}x{m}/x0"], n, m))
    x = torch.from_numpy(_tiles_of(jax_exchange[f"{n}x{m}/x"], n, m))
    got = halo_exchange_2d_ragged(x0, halo, rows, cols, out_extents=oe)
    want = _tiles_of(jax_exchange[key + "/ragged"], n, m)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    for i, r in enumerate(rows):       # pad slots exactly zero
        for j, c in enumerate(cols):
            assert not got[i, j, :, top + r + bottom:].any()
            assert not got[i, j, :, :, left + c + right:].any()
    got = halo_exchange_2d_spec(x, halo, rows, cols, out_extents=oe)
    np.testing.assert_array_equal(got.numpy(), _tiles_of(jax_exchange[key + "/spec"], n, m))


def test_ragged_exchange_refuses_a_halo_wider_than_the_smallest_tile():
    with pytest.raises(ValueError, match="exceeds the smallest tile"):
        halo_exchange_2d_ragged(torch.zeros(2, 2, 1, 5, 5, 1), (2, 2, 0, 0), (5, 1), (5, 5))


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

PI = dict(hw="pi3x3+jetson", batch=4, microbatches=2)
CASES = {
    # name: (layers, input hw, groups, planner kwargs)
    "conv7": ([jax_yolo_layers()[0]], (7, 7), None, {}),
    "yolo4-34": (jax_yolo_layers()[:4], (34, 34), None, {}),
    "pi3x3+jetson-64": (jax_yolo_layers()[:8], (64, 64), "auto", PI),
    "pi3x3+jetson-64-crossover": (jax_yolo_layers()[:8], (64, 64), "auto", dict(PI, crossover=6)),
}
BATCH, MICRO = 8, 2


def _case_data(name):
    layers, hw, _, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    x = rng.standard_normal((BATCH, *hw, 3)).astype(np.float32)
    t = (0.05 * rng.standard_normal((BATCH, *_out_hw(layers, hw), layers[-1].out_channels))
         ).astype(np.float32)
    return _np_params(layers, seed=sorted(CASES).index(name)), x, t


def _plan(name, ragged_exec, backend="torch", **extra):
    layers, hw, groups, kw = CASES[name]
    return tfu.build_stack_plan(hw, _port(layers), 2, 2, groups, backend=backend,
                                ragged_exec=ragged_exec, **dict(kw, **extra))


_JAX_EXEC = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from repro.core.fusion import (build_stack_plan, make_deferred_grad_step,
                                   make_tiled_forward, make_tiled_loss)
    from repro.core.spatial import LayerDef
    from repro.launch.mesh import make_tile_mesh
    from repro.models.yolo import l2_loss_local
    CASES, MICRO = %r, %d
    d = dict(np.load(sys.argv[1]))
    out = {}
    mesh = make_tile_mesh(2, 2)
    for name, (layers, hw, groups, kw) in CASES.items():
        layers = [LayerDef(**l) for l in layers]
        params = [{k: d[f"{name}/p{i}_{k}"] for k in ("w", "b", "bn_scale", "bn_bias")
                   if f"{name}/p{i}_{k}" in d} for i in range(len(layers))]
        x, t = d[f"{name}/x"], d[f"{name}/t"]
        xs, ts = x.reshape(MICRO, -1, *x.shape[1:]), t.reshape(MICRO, -1, *t.shape[1:])
        for ex in ("spec", "padded"):
            plan = build_stack_plan(tuple(hw), layers, 2, 2, groups, ragged_exec=ex, **kw)
            assert not plan.is_uniform
            out[f"{name}/{ex}/y"] = np.asarray(jax.jit(make_tiled_forward(plan, mesh))(params, x))
            out[f"{name}/{ex}/loss"] = np.asarray(
                jax.jit(make_tiled_loss(plan, mesh, l2_loss_local))(params, x, t))
            step = make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=MICRO)
            loss, grads = jax.jit(step)(params, xs, ts)
            out[f"{name}/{ex}/step_loss"] = np.asarray(loss)
            for i, g in enumerate(grads):
                for k, v in g.items():
                    out[f"{name}/{ex}/g{i}_{k}"] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def jax_ragged(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ragged")
    inputs = {}
    for name in CASES:
        params, x, t = _case_data(name)
        inputs[f"{name}/x"], inputs[f"{name}/t"] = x, t
        for i, p in enumerate(params):
            for k, v in p.items():
                inputs[f"{name}/p{i}_{k}"] = v
    np.savez(tmp / "in.npz", **inputs)
    cases = {name: ([dataclasses.asdict(l) for l in layers], list(hw), groups, kw)
             for name, (layers, hw, groups, kw) in CASES.items()}
    _run(_JAX_EXEC % (cases, MICRO), [tmp / "in.npz", tmp / "out.npz"], 4)
    return dict(np.load(tmp / "out.npz"))


def _grads_of(d, prefix, params):
    return [{k: d[f"{prefix}g{i}_{k}"] for k in p} for i, p in enumerate(params)]


def _grad_bars(case, params, x, t, micro):
    """Per leaf: max(GRAD_ATOL, GRAD_FLOOR_FACTOR x the untiled fp32
    reference's max |diff| from fp64) for the loss averaged over ``micro``
    microbatches, each with its own BN statistics (the deferred step's)."""
    plan = _plan(case, "spec")

    def grads(dtype):
        tp = [{k: v.to(dtype).requires_grad_(True) for k, v in p.items()}
              for p in params_from_jax(params, "cpu")]
        loss = sum(tfu.reference_loss(tp, torch.from_numpy(xm).to(dtype),
                                      torch.from_numpy(tm).to(dtype), plan, l2_loss_local)
                   for xm, tm in zip(np.split(x, micro), np.split(t, micro))) / micro
        return torch.autograd.grad(loss, _leaves(tp))

    g64 = grads(torch.float64)
    return iter(max(GRAD_ATOL, GRAD_FLOOR_FACTOR * float((a.double() - b).abs().max()))
                for a, b in zip(grads(torch.float32), g64))


@pytest.mark.parametrize("ragged_exec", EXECS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_executors_match_the_references_ragged_plans(jax_ragged, case, ragged_exec):
    """Forward, loss and the microbatched deferred step of each executor
    against the reference's plan with the same ``ragged_exec`` on its 2x2
    mesh."""
    params, x, t = _case_data(case)
    plan = _plan(case, ragged_exec, backend="cuda")
    assert not plan.is_uniform and plan.ragged_exec == ragged_exec
    mesh = make_tile_mesh(2, 2, "cpu")
    tp = params_from_jax(params, "cpu")
    key = f"{case}/{ragged_exec}/"
    got = tfu.make_tiled_forward(plan, mesh)(tp, x)
    assert tuple(got.shape) == jax_ragged[key + "y"].shape
    np.testing.assert_allclose(got.detach().numpy(), jax_ragged[key + "y"], atol=FWD_ATOL)
    loss = float(tfu.make_tiled_loss(plan, mesh, l2_loss_local)(tp, x, t))
    want = float(jax_ragged[key + "loss"])
    assert abs(loss - want) <= LOSS_RTOL * abs(want)
    step = tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=MICRO)
    sloss, grads = step(tp, x.reshape(MICRO, -1, *x.shape[1:]), t.reshape(MICRO, -1, *t.shape[1:]))
    want = float(jax_ragged[key + "step_loss"])
    assert abs(float(sloss) - want) <= LOSS_RTOL * abs(want)
    bars = _grad_bars(case, params, x, t, MICRO)
    for g, w in zip(grads, _grads_of(jax_ragged, key, params)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k].numpy(), w[k], atol=next(bars), err_msg=k)


@pytest.mark.parametrize("ragged_exec", EXECS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_loss_and_grads_match_the_untiled_reference(case, ragged_exec):
    """``make_tiled_loss`` of each executor and its gradients against the
    reference's untiled ``reference_loss`` (check_pipeline.py's bars)."""
    params, x, t = _case_data(case)
    layers, hw, _, _ = CASES[case]
    jplan = jfu.build_stack_plan(hw, layers, 1, 1)
    ref, ref_g = jax.value_and_grad(lambda p: jfu.reference_loss(p, x, t, jplan, jax_l2))(params)
    plan = _plan(case, ragged_exec)
    tp = [{k: v.requires_grad_(True) for k, v in p.items()} for p in params_from_jax(params, "cpu")]
    loss = tfu.make_tiled_loss(plan, make_tile_mesh(2, 2, "cpu"), l2_loss_local)(tp, x, t)
    assert abs(loss.item() - float(ref)) <= LOSS_RTOL * abs(float(ref))
    g = iter(torch.autograd.grad(loss, _leaves(tp)))
    bars = _grad_bars(case, params, x, t, 1)
    for p, w in zip(tp, ref_g):
        for k in p:
            np.testing.assert_allclose(next(g).numpy(), np.asarray(w[k]), atol=next(bars),
                                       err_msg=k)


@pytest.mark.parametrize("ragged_exec", EXECS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_ragged_executors_are_exact_in_fp64(case, ragged_exec):
    """In fp64 the forward, loss and gradients of each executor equal the
    untiled fp64 reference to rounding: the partition changes which tile
    computes a value, never the value."""
    params, x, t = _case_data(case)
    plan = _plan(case, ragged_exec)
    mesh = make_tile_mesh(2, 2, "cpu")
    x64, t64 = torch.from_numpy(x).double(), torch.from_numpy(t).double()

    def live():
        return [{k: v.double().requires_grad_(True) for k, v in p.items()}
                for p in params_from_jax(params, "cpu")]

    with torch.no_grad():
        y = tfu.make_tiled_forward(plan, mesh)(live(), x64)
        y_ref = tfu.reference_forward(live(), x64, plan)
    assert float((y - y_ref).abs().max()) < FP64_ATOL
    tp, rp = live(), live()
    loss = tfu.make_tiled_loss(plan, mesh, l2_loss_local)(tp, x64, t64)
    ref = tfu.reference_loss(rp, x64, t64, plan, l2_loss_local)
    assert abs(loss.item() - ref.item()) < FP64_ATOL
    for a, b in zip(torch.autograd.grad(loss, _leaves(tp)), torch.autograd.grad(ref, _leaves(rp))):
        assert float((a - b).abs().max()) < FP64_ATOL


@pytest.mark.parametrize("ragged_exec", EXECS)
def test_deferred_step_equals_the_loss_on_the_whole_batch_without_bn(ragged_exec):
    """With BN off the microbatched deferred step is the gradient of the
    loss on the concatenated batch, on the cluster plan and its crossover
    twin alike."""
    layers = yolov2_16_layers(batch_norm=False)[:8]
    for extra in ({}, dict(crossover=6)):
        plan = tfu.build_stack_plan((64, 64), layers, 2, 2, "auto", ragged_exec=ragged_exec,
                                    **dict(PI, **extra))
        mesh = make_tile_mesh(2, 2, "cpu")
        params = tsp.init_stack_params(torch.Generator().manual_seed(1), layers)
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal((8, 64, 64, 3)).astype(np.float32))
        t = torch.from_numpy(0.05 * rng.standard_normal((8, 8, 8, 128)).astype(np.float32))
        loss_d, grads = tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=2)(
            params, x.reshape(2, 4, 64, 64, 3), t.reshape(2, 4, 8, 8, 128))
        tp = [{k: v.clone().requires_grad_(True) for k, v in p.items()} for p in params]
        loss_r = tfu.make_tiled_loss(plan, mesh, l2_loss_local)(tp, x, t)
        assert float(loss_d) == pytest.approx(loss_r.item(), rel=LOSS_RTOL)
        for a, b in zip(_leaves(grads), torch.autograd.grad(loss_r, _leaves(tp))):
            assert float((a - b).abs().max()) < GRAD_ATOL


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("ragged_exec", EXECS)
@pytest.mark.parametrize("name", ["grid3", "cluster", "cluster_crossover"])
def test_phase14_plans_416_equal_the_references(name, ragged_exec):
    """The three plans ``chip_smoke.py``'s phase 14 runs on the card
    (``RAGGED_PLANS_416``) are the reference's: tile rows and columns per
    layer, group halos, groups and modes; and their launch counts per
    dispatch or microbatch are the ones written down (``RAGGED_LAUNCHES``:
    one B1 per class and conv under spec, one per conv padded)."""
    grid, groups, kw, want_groups = _chip_smoke().RAGGED_PLANS_416[name]
    jgroups = groups if groups == "auto" else [JGroup(*g) for g in groups]
    tgroups = groups if groups == "auto" else [Group(*g) for g in groups]
    jp = jfu.build_stack_plan((416, 416), jax_yolo_layers(), grid, grid, jgroups,
                              ragged_exec=ragged_exec, **kw)
    tp = tfu.build_stack_plan((416, 416), yolov2_16_layers(), grid, grid, tgroups,
                              ragged_exec=ragged_exec, device="cpu", **kw)
    assert not tp.is_uniform and tp.ragged_exec == ragged_exec
    for f in ("tile_rows", "tile_cols", "group_halos", "rem_halos", "shard_hw", "crossover"):
        assert getattr(tp, f) == getattr(jp, f), f
    got = [(g.start, g.end, g.mode) for g in tp.groups]
    assert got == [(g.start, g.end, g.mode) for g in jp.groups] == [tuple(g) for g in want_groups]
    per_mb, _ = _chip_smoke().launches_per_batch(tp, 1)
    assert per_mb == _chip_smoke().RAGGED_LAUNCHES[name][ragged_exec]


def test_explicit_even_partition_is_todays_uniform_plan_and_path(monkeypatch):
    """A uniform partition given explicitly (``TilePartition.even``) plans
    the same dataclass as none, and runs the uniform executor: the ragged
    group executors and reshard are never called."""
    layers = yolov2_16_layers()[:4]
    for kw in ({}, dict(crossover=2), dict(schedule="overlap")):
        plan = tfu.build_stack_plan((32, 32), layers, 2, 2, **kw)
        even = tfu.build_stack_plan((32, 32), layers, 2, 2,
                                    partition=TilePartition.even(32, 32, 2, 2), **kw)
        assert even == plan and plan.is_uniform

    def refuse(*a, **k):
        raise AssertionError("a uniform plan reached a ragged executor")

    for fn in ("_apply_group_spec", "_apply_group_ragged", "reshard_spatial_to_data_ragged"):
        monkeypatch.setattr(tfu, fn, refuse)
    params = tsp.init_stack_params(torch.Generator().manual_seed(0), layers)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    for kw in ({}, dict(crossover=2)):
        plan = tfu.build_stack_plan((32, 32), layers, 2, 2,
                                    partition=TilePartition.even(32, 32, 2, 2), **kw)
        got = tfu.make_tiled_forward(plan, make_tile_mesh(2, 2, "cpu"))(params, x)
        np.testing.assert_allclose(got.detach().numpy(),
                                   tfu.reference_forward(params, x, plan).numpy(), atol=FWD_ATOL)


@pytest.mark.parametrize("ragged_exec", EXECS)
def test_overlap_schedule_on_a_ragged_plan_runs_the_sync_exchange(monkeypatch, ragged_exec):
    """A ragged plan keeps ``schedule="overlap"`` in its manifest but runs
    the sync exchange: the interior/boundary split is never called and the
    result is the sync plan's, bit for bit."""
    layers = yolov2_16_layers()[:4]
    part = TilePartition((0, 24, 32), (0, 16, 32))
    sync = tfu.build_stack_plan((32, 32), layers, 2, 2, [Group(0, 3)], partition=part,
                                ragged_exec=ragged_exec)
    ovl = tfu.build_stack_plan((32, 32), layers, 2, 2, [Group(0, 3)], partition=part,
                               ragged_exec=ragged_exec, schedule="overlap")
    assert ovl.schedule == "overlap" and not ovl.is_uniform

    def refuse(*a, **k):
        raise AssertionError("a ragged plan ran the overlap split")

    monkeypatch.setattr(tfu, "apply_group_lead_overlap", refuse)
    params = tsp.init_stack_params(torch.Generator().manual_seed(0), layers)
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    mesh = make_tile_mesh(2, 2, "cpu")
    assert torch.equal(tfu.make_tiled_forward(ovl, mesh)(params, x),
                       tfu.make_tiled_forward(sync, mesh)(params, x))


def test_spec_and_padded_plans_key_the_serve_cache_apart():
    layers = yolov2_16_layers()[:4]
    part = TilePartition((0, 24, 32), (0, 16, 32))
    plans = [tfu.build_stack_plan((32, 32), layers, 2, 2, partition=part, ragged_exec=ex,
                                  inference=True) for ex in EXECS]
    assert plans[0].tile_rows == plans[1].tile_rows
    assert plan_cache_key(plans[0], 4) != plan_cache_key(plans[1], 4)
    with pytest.raises(ValueError, match="ragged_exec must be"):
        tfu.build_stack_plan((32, 32), layers, 2, 2, ragged_exec="masked")


@pytest.mark.parametrize("ragged_exec", EXECS)
def test_a_training_step_after_a_serve_step_of_the_same_plan(ragged_exec):
    """The ragged exchanges' index tables are made once per device; made
    first by a serve step (inside ``torch.inference_mode``), they must still
    serve a training step's backward in the same process."""
    layers = yolov2_16_layers()[:4]
    plan = tfu.build_stack_plan((32, 32), layers, 2, 2, ragged_exec=ragged_exec,
                                partition=TilePartition((0, 12, 32), (0, 20, 32)))
    assert not plan.is_uniform
    mesh = make_tile_mesh(2, 2, "cpu")
    params = tsp.init_stack_params(torch.Generator().manual_seed(3), layers)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 32, 32, 3)
                                                                   ).astype(np.float32))
    tfu.make_tiled_infer(plan.inference_twin(), mesh)(tsp.freeze_bn_stats(params, layers, x), x)
    live = [{k: v.requires_grad_(True) for k, v in p.items()} for p in params]
    t = torch.zeros(2, *plan.out_hw(), layers[-1].out_channels)
    loss = tfu.make_tiled_loss(plan, mesh, l2_loss_local)(live, x, t)
    grads = torch.autograd.grad(loss, [v for p in live for v in p.values()])
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("ragged_exec", EXECS)
def test_serve_engine_serves_a_ragged_plan(ragged_exec):
    """The reference's ragged serve plan (``tests/test_serve_cnn.py:116``,
    ``TilePartition((0, 6, 16), (0, 10, 16))`` on 2x2) through the engine:
    every response is the untiled frozen-BN forward."""
    layers = [tsp.LayerDef(3, 1, 3, 8, act="leaky", batch_norm=True, use_bias=False),
              tsp.LayerDef(2, 2, 8, 8, pool=True, act="linear"),
              tsp.LayerDef(3, 1, 8, 8, act="leaky")]
    plan = tfu.build_stack_plan((16, 16), layers, 2, 2,
                                partition=TilePartition((0, 6, 16), (0, 10, 16)),
                                ragged_exec=ragged_exec, backend="cuda", inference=True)
    assert not plan.is_uniform and plan.tile_rows[-1] == (3, 5)
    params = tsp.init_stack_params(torch.Generator().manual_seed(0), layers)
    rng = np.random.default_rng(4)
    frozen = tsp.freeze_bn_stats(params, layers, torch.from_numpy(
        rng.standard_normal((4, 16, 16, 3)).astype(np.float32)))
    eng = CNNServeEngine(plan, make_tile_mesh(2, 2, "cpu"), frozen, buckets=(1, 2, 4),
                         step_bound=0.01, latency_budget=1.0, clock=ManualClock(),
                         simulate_step_s=0.01)
    images = rng.standard_normal((7, 16, 16, 3)).astype(np.float32)
    for im in images:
        eng.submit(im)
    eng.drain()
    got = np.stack([r.result for r in sorted(eng.finished, key=lambda r: r.rid)])
    want = tfu.reference_forward(frozen, torch.from_numpy(images), plan).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# tied max pool
# ---------------------------------------------------------------------------


def test_tied_max_pool_sends_the_gradient_to_the_first_maximum():
    """A window with tied maxima gets its whole cotangent on the first one
    in row-major order - the reference's ``select_and_scatter`` (its
    ``reduce_window`` pool) and its spec executor's ``_pool_nonoverlap`` -
    in the port's pool and its spec class path."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 3, (2, 8, 6, 3)).astype(np.float32)     # many ties
    dy = rng.standard_normal((2, 4, 3, 3)).astype(np.float32)
    pool = tsp.LayerDef(2, 2, 3, 3, pool=True, act="linear")
    want = jax.vjp(lambda a: jsp._valid_pool(a, 2, 2), jnp.asarray(x))[1](jnp.asarray(dy))[0]
    want_spec = jax.vjp(lambda a: jsp._pool_nonoverlap(a, 2), jnp.asarray(x))[1](jnp.asarray(dy))[0]
    np.testing.assert_array_equal(np.asarray(want), np.asarray(want_spec))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = tsp._conv_or_pool_spec(xt, {}, pool, "torch", None, (4, 3))
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(dy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the code's launch count
# ---------------------------------------------------------------------------

CALLS: list = []


def _recording_conv(x, w, b, *, stride, act, block_oh=None):
    CALLS.append((tuple(x.shape), tuple(w.shape), stride))
    return _torch_conv(x, w, b, stride=stride, act=act)


register_conv_backend("recording_ragged", _recording_conv, fused_acts=("linear",))


@pytest.mark.parametrize("ragged_exec", EXECS)
@pytest.mark.parametrize("case", ["yolo4-34", "pi3x3+jetson-64", "pi3x3+jetson-64-crossover"])
def test_chip_smoke_conv_shapes_are_the_ragged_executors_calls(case, ragged_exec):
    """``conv_shapes`` lists exactly the conv calls, in order and by shape,
    that each ragged executor makes: one per layer over every padded tile,
    or one per shape class and layer."""
    smoke = _chip_smoke()
    plan = _plan(case, ragged_exec, backend="recording_ragged")
    params = tsp.init_stack_params(torch.Generator().manual_seed(0), plan.layers)
    CALLS.clear()
    tfu.make_tiled_forward(plan, make_tile_mesh(2, 2, "cpu"))(params,
                                                             torch.zeros(4, *plan.input_hw, 3))
    want = [(s["x"], s["w"], s["stride"]) for s in smoke.conv_shapes(plan, 4)]
    assert CALLS == want
    counts, _ = smoke.launches_per_batch(plan, 4)
    assert counts["conv2d_tile"] == len(CALLS)
