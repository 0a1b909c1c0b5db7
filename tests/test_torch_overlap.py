"""The port's overlap schedule (DESIGN.md §5) against the JAX reference.

- the packed exchanges (``halo_exchange_{1,2}d_packed``) equal, bit for
  bit, to the reference's inside ``shard_map`` on 1x2, 2x2 and 3x3 meshes
  with asymmetric and zero halos (a subprocess with 9 fake devices), and
  both branches (the 2-tile swap, the shifts of a longer axis) equal to the
  eager exchange's strips;
- ``schedule="overlap"`` on the 2x2 virtual mesh against the sync schedule,
  JAX's untiled reference, and JAX's own 2x2 overlap plan (a subprocess
  with 4 fake devices), at ``scripts/check_overlap.py``'s bar: forward
  1e-4, loss 1e-5, grads 1e-4; the no-interior fallback likewise;
- ``chip_smoke.py``'s ``conv_shapes``, the code's launch count, against the
  conv calls the executor really makes.
"""
import dataclasses
import importlib.util
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
from repro.models.yolo import l2_loss_local as jax_l2
from repro_torch.core import fusion as tfu
from repro_torch.core import spatial as tsp
from repro_torch.core.backend import _torch_conv, register_conv_backend
from repro_torch.core.halo import (
    halo_exchange_1d,
    halo_exchange_1d_packed,
    halo_exchange_2d,
    halo_exchange_2d_packed,
)
from repro_torch.core.tiling import Group
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_tile_mesh
from repro_torch.models.yolo import l2_loss_local

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# scripts/check_overlap.py:90
FWD_ATOL, LOSS_ATOL, GRAD_ATOL = 1e-4, 1e-5, 1e-4
HW = (32, 32)
TH, TW = 4, 5                           # tile extents of the exchange tests

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
GROUPINGS = {
    "per-layer": None,
    "pairs": [(0, 1), (2, 3), (4, 5), (6, 7)],
    "yolo-4": [(0, 3), (4, 7)],
    "single": [(0, 7)],
}
# a tile thinner than the kernel's reach into its halo: no interior
FALLBACK_LAYERS = [
    jsp.LayerDef(3, 1, 3, 4, act="leaky"),
    jsp.LayerDef(3, 1, 4, 4, act="relu", batch_norm=True, use_bias=False),
]
FALLBACK_HW = (4, 4)

MESHES = [(1, 2), (2, 2), (3, 3)]
HALOS = [(1, 1, 1, 1), (2, 1, 0, 3), (0, 0, 1, 2), (0, 0, 0, 0), (3, 0, 2, 1), (1, 2, 2, 0)]


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


def _run(script: str, out, devices: int) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", script, str(out)], env=env, check=True, timeout=600)
    return dict(np.load(out))


# ---------------------------------------------------------------------------
# packed exchanges
# ---------------------------------------------------------------------------

_JAX_PACKED = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.core.halo import halo_exchange_1d_packed, halo_exchange_2d_packed
    MESHES = %r
    HALOS = %r
    TH, TW = %d, %d
    out = {}
    for n, m in MESHES:
        mesh = Mesh(np.array(jax.devices()[:n * m]).reshape(n, m), ("th", "tw"))
        x = np.random.default_rng(n * 10 + m).standard_normal((2, n * TH, m * TW, 3)).astype(np.float32)
        out[f"x_{n}x{m}"] = x
        spec = P(None, "th", "tw", None)
        for halo in HALOS:
            top, bottom, left, right = halo
            def f(t):
                r = halo_exchange_1d_packed(t, top, bottom, "th", dim=1)
                c = halo_exchange_1d_packed(t, left, right, "tw", dim=2)
                return (*r, *c, *halo_exchange_2d_packed(t, halo, "th", "tw", dims=(1, 2)))
            got = jax.jit(shard_map(f, mesh=mesh, in_specs=(spec,), out_specs=(spec,) * 7,
                                    check_rep=False))(x)
            for i, g in enumerate(got):
                out[f"{n}x{m}_{'_'.join(map(str, halo))}_{i}"] = np.asarray(g)
    np.savez(sys.argv[1], **out)
""") % (MESHES, HALOS, TH, TW)


@pytest.fixture(scope="module")
def jax_packed(tmp_path_factory):
    return _run(_JAX_PACKED, tmp_path_factory.mktemp("packed") / "packed.npz", 9)


def _tiles_of(global_arr, n, m):
    """Per-device blocks of a shard_map output gathered along (H, W):
    (B, n*h, m*w, C) -> (n, m, B, h, w, C)."""
    b, gh, gw, c = global_arr.shape
    return global_arr.reshape(b, n, gh // n, m, gw // m, c).transpose(1, 3, 0, 2, 4, 5)


@pytest.mark.parametrize("halo", HALOS)
@pytest.mark.parametrize("grid", MESHES)
def test_packed_exchanges_equal_the_reference(jax_packed, grid, halo):
    n, m = grid
    top, bottom, left, right = halo
    tiles = make_tile_mesh(n, m, "cpu").split(torch.from_numpy(jax_packed[f"x_{n}x{m}"]))
    row = halo_exchange_1d_packed(tiles, top, bottom, tile_dim=0, dim=3)
    col = halo_exchange_1d_packed(tiles, left, right, tile_dim=1, dim=4)
    got = (*row, *col, *halo_exchange_2d_packed(tiles, halo))
    key = f"{n}x{m}_{'_'.join(map(str, halo))}"
    for i, g in enumerate(got):
        want = _tiles_of(jax_packed[f"{key}_{i}"], n, m)
        assert tuple(g.shape) == want.shape, (i, tuple(g.shape), want.shape)
        np.testing.assert_array_equal(g.numpy(), want, err_msg=f"output {i}")


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("lo,hi", [(1, 1), (2, 3), (0, 2), (3, 0), (0, 0)])
def test_packed_strips_are_the_eager_exchanges(n, lo, hi):
    """Both branches - the 2-tile swap masked by tile index, and the shifts
    of a longer axis - deliver the strips the eager exchange attaches, with
    zeros at the ends."""
    x = torch.randn(n, 2, 1, 4, 3, 2, generator=torch.Generator().manual_seed(n))
    recv_lo, recv_hi = halo_exchange_1d_packed(x, lo, hi, tile_dim=0, dim=3)
    assert recv_lo.shape[3] == lo and recv_hi.shape[3] == hi
    assert torch.equal(torch.cat([recv_lo, x, recv_hi], dim=3),
                       halo_exchange_1d(x, lo, hi, tile_dim=0, dim=3))
    if lo:
        assert not recv_lo[0].any()
    if hi:
        assert not recv_hi[-1].any()


def test_packed_2d_concatenates_to_the_eager_exchange():
    x = torch.randn(3, 2, 2, 4, 5, 3, generator=torch.Generator().manual_seed(0))
    for halo in HALOS:
        x_rows, col_lo, col_hi = halo_exchange_2d_packed(x, halo)
        assert torch.equal(torch.cat([col_lo, x_rows, col_hi], dim=4), halo_exchange_2d(x, halo))


def test_packed_halo_wider_than_tile_rejected():
    with pytest.raises(ValueError, match="exceeds the tile extent"):
        halo_exchange_1d_packed(torch.zeros(2, 1, 1, 3, 3, 1), 4, 1, tile_dim=0, dim=3)


# ---------------------------------------------------------------------------
# the overlap executor
# ---------------------------------------------------------------------------


def _data(layers, hw, b=2, seed=1):
    out_hw = hw
    for l in layers:
        out_hw = (l.out_extent(out_hw[0]), l.out_extent(out_hw[1]))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, *hw, 3)).astype(np.float32)
    t = (0.1 * rng.standard_normal((b, *out_hw, layers[-1].out_channels))).astype(np.float32)
    return x, t


def _port_loss_grads(plan, params, x, t):
    mesh = make_tile_mesh(plan.n, plan.m, "cpu")
    y = tfu.make_tiled_forward(plan, mesh)(params_from_jax(params, "cpu"), x).detach()
    tp = [{k: v.requires_grad_(True) for k, v in p.items()} for p in params_from_jax(params, "cpu")]
    loss = tfu.make_tiled_loss(plan, mesh, l2_loss_local)(tp, x, t)
    g = iter(torch.autograd.grad(loss, [v for p in tp for v in p.values()]))
    return y.numpy(), float(loss.detach()), [{k: next(g).numpy() for k in p} for p in tp]


def _jax_untiled(layers, hw, params, x, t):
    plan = jfu.build_stack_plan(hw, layers, 1, 1)
    y = np.asarray(jfu.reference_forward(params, x, plan))
    loss, grads = jax.value_and_grad(lambda p: jfu.reference_loss(p, x, t, plan, jax_l2))(params)
    return y, float(loss), [{k: np.asarray(v) for k, v in g.items()} for g in grads]


def _assert_close(got, want, what):
    y, loss, grads = got
    wy, wloss, wgrads = want
    assert y.shape == wy.shape
    assert np.max(np.abs(y - wy)) < FWD_ATOL, f"{what}: forward"
    assert abs(loss - wloss) < LOSS_ATOL, f"{what}: loss"
    for g, w in zip(grads, wgrads):
        assert set(g) == set(w)
        for k in w:
            assert np.max(np.abs(g[k] - w[k])) < GRAD_ATOL, f"{what}: grad {k}"


def _plan(layers, hw, groups, schedule, backend):
    g = None if groups is None else [Group(s, e) for s, e in groups]
    return tfu.build_stack_plan(hw, _port(layers), 2, 2, g, backend=backend, schedule=schedule)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("grouping", sorted(GROUPINGS))
def test_overlap_equals_sync_and_the_untiled_reference(grouping, backend):
    params = _np_params(NARROW_YOLO)
    x, t = _data(NARROW_YOLO, HW)
    ovl = _plan(NARROW_YOLO, HW, GROUPINGS[grouping], "overlap", backend)
    assert ovl.schedule == "overlap"
    got = _port_loss_grads(ovl, params, x, t)
    _assert_close(got, _port_loss_grads(_plan(NARROW_YOLO, HW, GROUPINGS[grouping], "sync",
                                              backend), params, x, t), "vs sync")
    _assert_close(got, _jax_untiled(NARROW_YOLO, HW, params, x, t), "vs JAX untiled")


def test_no_interior_fallback_matches_sync_and_reference():
    """Tiles of 2x2 under a group halo of 2: ``split_1d`` finds no interior,
    and the lead runs as one conv on the whole extended tile."""
    assert tsp.split_1d(2, 2, 2, 3, 1) is None
    params = _np_params(FALLBACK_LAYERS)
    x, t = _data(FALLBACK_LAYERS, FALLBACK_HW, b=3)
    ovl = _plan(FALLBACK_LAYERS, FALLBACK_HW, [(0, 1)], "overlap", "cuda")
    assert ovl.group_halos == ((2, 2, 2, 2),)
    got = _port_loss_grads(ovl, params, x, t)
    _assert_close(got, _port_loss_grads(_plan(FALLBACK_LAYERS, FALLBACK_HW, [(0, 1)], "sync",
                                              "cuda"), params, x, t), "vs sync")
    _assert_close(got, _jax_untiled(FALLBACK_LAYERS, FALLBACK_HW, params, x, t), "vs JAX untiled")


_JAX_OVERLAP_2X2 = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from repro.core.fusion import build_stack_plan, make_tiled_forward, make_tiled_loss
    from repro.core.spatial import LayerDef, init_stack_params
    from repro.core.tiling import Group
    from repro.launch.mesh import make_tile_mesh
    from repro.models.yolo import l2_loss_local
    CASES = %r
    out = {}
    mesh = make_tile_mesh(2, 2)
    for name, (layers, hw, groups, backend) in CASES.items():
        layers = [LayerDef(**l) for l in layers]
        params = init_stack_params(jax.random.PRNGKey(0), layers)
        out_hw = tuple(hw)
        for l in layers:
            out_hw = (l.out_extent(out_hw[0]), l.out_extent(out_hw[1]))
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
        t = (0.1 * rng.standard_normal((2, *out_hw, layers[-1].out_channels))).astype(np.float32)
        g = None if groups is None else [Group(s, e) for s, e in groups]
        plan = build_stack_plan(tuple(hw), layers, 2, 2, g, backend=backend, schedule="overlap")
        loss_fn = make_tiled_loss(plan, mesh, l2_loss_local)
        loss, grads = jax.jit(jax.value_and_grad(lambda p: loss_fn(p, x, t)))(params)
        out[f"{name}/y"] = np.asarray(jax.jit(make_tiled_forward(plan, mesh))(params, x))
        out[f"{name}/loss"] = np.asarray(loss)
        out[f"{name}/x"], out[f"{name}/t"] = x, t
        for i, (p, gr) in enumerate(zip(params, grads)):
            for k in p:
                out[f"{name}/p{i}_{k}"] = np.asarray(p[k])
                out[f"{name}/g{i}_{k}"] = np.asarray(gr[k])
    np.savez(sys.argv[1], **out)
""")
JAX_OVERLAP_CASES = {
    "yolo-4-pallas": (NARROW_YOLO[:4], HW, [(0, 3)], "pallas"),
    "yolo-8-pairs-xla": (NARROW_YOLO, HW, GROUPINGS["pairs"], "xla"),
    "yolo-8-grouped-xla": (NARROW_YOLO, HW, GROUPINGS["yolo-4"], "xla"),
    "fallback-xla": (FALLBACK_LAYERS, FALLBACK_HW, [(0, 1)], "xla"),
}


@pytest.fixture(scope="module")
def jax_overlap(tmp_path_factory):
    cases = {name: ([dataclasses.asdict(l) for l in layers], list(hw), groups, backend)
             for name, (layers, hw, groups, backend) in JAX_OVERLAP_CASES.items()}
    return _run(_JAX_OVERLAP_2X2 % (cases,), tmp_path_factory.mktemp("ovl") / "ovl.npz", 4)


def _unpack(d, name, n_layers, prefix):
    out = [{} for _ in range(n_layers)]
    for key in d:
        if key.startswith(f"{name}/{prefix}"):
            i, k = key[len(name) + 1 + len(prefix):].split("_", 1)
            out[int(i)][k] = d[key]
    return out


@pytest.mark.parametrize("case", sorted(JAX_OVERLAP_CASES))
def test_overlap_matches_the_references_2x2_overlap_plan(jax_overlap, case):
    layers, hw, groups, _ = JAX_OVERLAP_CASES[case]
    params = _unpack(jax_overlap, case, len(layers), "p")
    want = (jax_overlap[f"{case}/y"], float(jax_overlap[f"{case}/loss"]),
            _unpack(jax_overlap, case, len(layers), "g"))
    x, t = jax_overlap[f"{case}/x"], jax_overlap[f"{case}/t"]
    for backend in ("torch", "cuda"):
        plan = _plan(layers, hw, groups, "overlap", backend)
        _assert_close(_port_loss_grads(plan, params, x, t), want, f"{case} {backend}")


# ---------------------------------------------------------------------------
# the code's launch count
# ---------------------------------------------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)
    spec.loader.exec_module(mod)
    return mod


CALLS: list = []


def _recording_conv(x, w, b, *, stride, act, block_oh=None):
    CALLS.append((tuple(x.shape), tuple(w.shape), stride))
    return _torch_conv(x, w, b, stride=stride, act=act)


register_conv_backend("recording", _recording_conv, fused_acts=("linear",))


@pytest.mark.parametrize("kw", [
    dict(groups=[Group(0, 3), Group(4, 7)], schedule="overlap"),
    dict(schedule="overlap"),
    dict(groups=[Group(0, 3), Group(4, 7)]),
    dict(groups=[Group(0, 3), Group(4, 5), Group(6, 7, "data")], schedule="overlap"),
    dict(crossover=0),
])
def test_chip_smoke_conv_shapes_are_the_executors_calls(kw):
    """``chip_smoke.py`` holds the card's launch counts to ``conv_shapes``:
    it lists exactly the conv calls, in order and by shape, that the
    executor makes - under overlap one per piece of a group lead."""
    smoke = _chip_smoke()
    kw = dict(kw)
    groups = kw.pop("groups", None)
    plan = tfu.build_stack_plan(HW, _port(NARROW_YOLO), 2, 2, groups, backend="recording", **kw)
    params = tsp.init_stack_params(torch.Generator().manual_seed(0), plan.layers)
    CALLS.clear()
    tfu.make_tiled_forward(plan, make_tile_mesh(2, 2, "cpu"))(params, torch.zeros(4, *HW, 3))
    want = [(s["x"], s["w"], s["stride"]) for s in smoke.conv_shapes(plan, 4)]
    assert CALLS == want
    counts, _ = smoke.launches_per_batch(plan, 4)
    assert counts["conv2d_tile"] == len(CALLS)
