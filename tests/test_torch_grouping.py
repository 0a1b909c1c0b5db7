"""The port's grouping cost model (``repro_torch/core/grouping.py``) against
the JAX reference's (``repro/core/grouping.py``), in process: the planner
needs no mesh and no tensor.

The port keeps the reference's order of arithmetic, so every comparison is
exact (``==`` on floats, groups, bounds and manifests), and every error the
reference raises the port raises with the same type and message.  Covered:
``profile_cost`` (each component) and ``modeled_step_wire_bytes`` over every
profile x schedule x wire codec x YOLOv2 prefix (depth 4/8/16, BN on/off,
input 64/416, grids 1x1, 2x2, 2x3), the same over explicit spatial, data
and pipeline groupings; ``optimize_grouping`` over the same sweep and with
``crossover="auto"``, ``pipeline="auto"`` and a ``mem_limit`` that binds;
``peak_device_memory``; ``balance_bounds`` and ``cluster_partition`` for
three clusters; the manifests; ``parse_cluster_spec``'s errors;
``split_1d``; the codec pricing; the stage and device-list helpers; a seeded
sweep of 50 random small stacks; and ``chip_smoke.py``'s ``AUTO_GROUPS_416``
against the reference's choice at the card run's configuration."""
import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.core import grouping as jg
from repro.core import spatial as jsp
from repro.core import tiling as jt
from repro.models.yolo import yolov2_16_layers as jax_yolo_layers
from repro.optim import compression as jcomp
from repro_torch.core import grouping as tg
from repro_torch.core import spatial as tsp
from repro_torch.core import tiling as tt
from repro_torch.optim import compression as tcomp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE_NAMES = sorted(jg.PROFILES)
SCHEDULES = ("sync", "overlap")
CODECS = ("none", "int8", "topk:0.1")
GRIDS = ((1, 1), (2, 2), (2, 3))
INPUTS = ((64, 64), (416, 416))
CLUSTERS = ("pi3x4", "pi3x3+jetson", "jetson+pi3x3")


class Gs(list):
    """A grouping profile as (start, end[, mode]) tuples, built into each
    side's own ``Group``s by ``_both``."""


def _port_layers(layers):
    return [tsp.LayerDef(**dataclasses.asdict(l)) for l in layers]


def _groups(spec, mod):
    """(start, end[, mode]) tuples -> ``mod.Group``s."""
    return [mod.Group(*g) for g in spec]


def _key(groups):
    return [(g.start, g.end, g.mode) for g in groups]


def _both(fn, *args, **kw):
    """(reference result, port result) of ``fn``, or each side's raised
    (type name, message)."""
    out = []
    for mod in (jg, tg):
        a = [_conv(v, mod) for v in args]
        k = {n: _conv(v, mod) for n, v in kw.items()}
        try:
            out.append(getattr(mod, fn)(*a, **k))
        except (ValueError, KeyError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def _conv(v, mod):
    """A reference-side value as ``mod`` wants it: layers, groups, profiles,
    clusters and partitions are rebuilt from the same fields."""
    if isinstance(v, list) and v and isinstance(v[0], jsp.LayerDef):
        return v if mod is jg else _port_layers(v)
    if isinstance(v, list) and v and isinstance(v[0], jg.HardwareProfile):
        return [_conv(p, mod) for p in v]
    if isinstance(v, Gs):
        return _groups(v, jt if mod is jg else tt)
    if isinstance(v, jg.HardwareProfile):
        return v if mod is jg else tg.HardwareProfile(**dataclasses.asdict(v))
    if isinstance(v, jg.ClusterSpec):
        return v if mod is jg else tg.cluster_from_manifest(jg.cluster_manifest(v))
    if isinstance(v, jt.TilePartition):
        return v if mod is jg else tt.TilePartition(v.row_bounds, v.col_bounds)
    return v


def _same(ref, port):
    if isinstance(ref, list) and ref and hasattr(ref[0], "start"):
        assert _key(port) == _key(ref)
    elif isinstance(ref, tuple) and len(ref) == 2 and isinstance(ref[0], str):
        assert port == ref                       # same exception type and message
    elif dataclasses.is_dataclass(ref):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    else:
        assert port == ref


def _stacks():
    """(name, layers) of the YOLOv2 prefixes the sweep plans."""
    out = []
    for depth in (4, 8, 16):
        for bn in (True, False):
            out.append((f"d{depth}-{'bn' if bn else 'nobn'}", jax_yolo_layers(batch_norm=bn)[:depth]))
    return out


def _explicit_groupings(L, n=2, m=2):
    """Spatial, data and, where two stages fit the n x m grid, pipeline
    profiles of an L-layer stack."""
    half = L // 2
    pipe = 2 in jg.feasible_stage_counts(n, m, L - half)
    return [Gs(g) for g in (
        [(i, i) for i in range(L)],
        [(0, L - 1)],
        [(0, half - 1), (half, L - 1)],
        [(i, min(i + 2, L - 1)) for i in range(0, L, 3)],
        [(0, half - 1), (half, L - 1, "data")],
        [(0, 0), (1, L - 1, "data")],
        [(0, L - 1, "data")],
        [(0, half - 1), (half, half + (L - half) // 2 - 1, "pipeline"),
         (half + (L - half) // 2, L - 1, "pipeline")],
    ) if pipe or g[-1][2:] != ("pipeline",)]


# ---------------------------------------------------------------------------
# profile_cost, modeled_step_wire_bytes, optimize_grouping, peak_device_memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stack", [s for s, _ in _stacks()])
@pytest.mark.parametrize("profile", PROFILE_NAMES)
def test_cost_and_wire_bytes_equal_reference(profile, stack):
    layers = dict(_stacks())[stack]
    hw = jg.PROFILES[profile]
    L = len(layers)
    for input_hw in INPUTS:
        for n, m in GRIDS:
            for groups in _explicit_groupings(L, n, m):
                for codec in CODECS:
                    for schedule in SCHEDULES:
                        for batch in (1, 8):
                            ref, port = _both("profile_cost", input_hw, layers, groups, n, m, hw,
                                              batch, schedule, wire_codec=codec)
                            assert set(ref) == {"compute", "boundary", "sync", "weights",
                                                "reshard", "hidden", "bubble", "total"}
                            assert port == ref, (input_hw, n, m, groups, codec, schedule, batch)
                    ref, port = _both("modeled_step_wire_bytes", input_hw, layers, groups, n, m,
                                      hw, 8, codec)
                    assert port == ref


@pytest.mark.parametrize("stack", [s for s, _ in _stacks()])
@pytest.mark.parametrize("profile", PROFILE_NAMES)
def test_optimize_grouping_equals_reference(profile, stack):
    layers = dict(_stacks())[stack]
    hw = jg.PROFILES[profile]
    for input_hw in INPUTS:
        for n, m in GRIDS:
            for codec in CODECS:
                for schedule in SCHEDULES:
                    for batch in (1, 8):
                        ref, port = _both("optimize_grouping", input_hw, layers, n, m, hw, batch,
                                          schedule=schedule, wire_codec=codec)
                        _same(ref, port)
            ref, port = _both("optimize_grouping", input_hw, layers, n, m, hw, 8,
                              crossover="auto")
            _same(ref, port)
            ref, port = _both("optimize_grouping", input_hw, layers, n, m, hw, 8,
                              pipeline="auto", microbatches=2)
            _same(ref, port)


@pytest.mark.parametrize("profile", PROFILE_NAMES)
def test_mem_limit_that_binds_equals_reference(profile):
    """A limit below the unconstrained optimum's modeled peak moves the
    choice (or refuses every candidate) the same way on both sides."""
    hw = jg.PROFILES[profile]
    layers = jax_yolo_layers()
    moved = 0
    for input_hw in INPUTS:
        free = jg.optimize_grouping(input_hw, layers, 2, 2, hw, batch=8)
        peak = jg.peak_device_memory(input_hw, layers, free, 2, 2, batch=8,
                                     dtype_bytes=hw.dtype_bytes)["total"]
        for frac in (0.999, 0.9, 0.5, 0.05):
            for crossover in (None, "auto"):
                ref, port = _both("optimize_grouping", input_hw, layers, 2, 2, hw, 8,
                                  crossover=crossover, mem_limit=frac * peak)
                _same(ref, port)
                moved += not isinstance(ref, tuple) and _key(ref) != _key(free)
    assert moved, "no limit moved the choice: the test would not see a binding limit"


@pytest.mark.parametrize("stack", [s for s, _ in _stacks()])
def test_peak_device_memory_equals_reference(stack):
    layers = dict(_stacks())[stack]
    L = len(layers)
    for input_hw in INPUTS:
        for n, m in GRIDS:
            for spec in _explicit_groupings(L, n, m):
                for batch in (1, 3, 8):
                    for db in (2, 4):
                        ref, port = _both("peak_device_memory", input_hw, layers, spec, n, m,
                                          batch=batch, dtype_bytes=db)
                        assert port == ref
    # a cluster's balanced (ragged) partition charges the padded tiles
    for name in CLUSTERS:
        cl = jg.parse_cluster_spec(name, 2, 2)
        part = jg.cluster_partition((416, 416), layers, cl)
        ref, port = _both("peak_device_memory", (416, 416), layers, Gs([(0, L - 1)]), 2, 2,
                          batch=4, partition=part)
        assert port == ref


def test_cluster_costs_and_groupings_equal_reference():
    layers = jax_yolo_layers()[:8]
    for name in CLUSTERS:
        cl = jg.parse_cluster_spec(name, 2, 2)
        for spec in _explicit_groupings(8):
            for codec in CODECS:
                ref, port = _both("profile_cost", (64, 64), layers, spec, 2, 2, cl, 4,
                                  wire_codec=codec)
                assert port == ref
            ref, port = _both("score_profile", (64, 64), layers, spec, 2, 2, cl, 4,
                              mem_limit=5e6)
            assert port == ref
        ref, port = _both("optimize_grouping", (64, 64), layers, 2, 2, cl, 4)
        _same(ref, port)
        ref, port = _both("optimize_grouping", (64, 64), layers, 2, 2, cl, 4, crossover="auto")
        _same(ref, port)


# ---------------------------------------------------------------------------
# clusters, partitions and manifests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CLUSTERS)
def test_balance_bounds_and_cluster_partition_equal_reference(name):
    cl = jg.parse_cluster_spec(name, 2, 2)
    for extent in ((13, 13), (26, 26), (32, 48), (64, 64), (7, 9)):
        for min_size in (1, 2, 4):
            ref, port = _both("balance_bounds", extent, cl, min_size=min_size)
            assert port == ref
    for depth, input_hw in ((4, (32, 32)), (8, (64, 64)), (16, (416, 416))):
        layers = jax_yolo_layers()[:depth]
        for cross in (None, depth // 2):
            ref, port = _both("cluster_partition", input_hw, layers, cl, cross)
            _same(ref, port)
    if name == "pi3x4":      # a uniform cluster keeps the even split
        assert tg.balance_bounds((64, 64), tg.parse_cluster_spec(name, 2, 2)) == \
            ((0, 32, 64), (0, 32, 64))


def test_manifests_round_trip_and_equal_reference():
    for spec, (n, m) in (("pi3x4", (2, 2)), ("pi3x3+jetson", (2, 2)), ("jetson-edgex3", (1, 3)),
                         ("tpu+pi3-core", (2, 1))):
        jc, tc = jg.parse_cluster_spec(spec, n, m), tg.parse_cluster_spec(spec, n, m)
        man = tg.cluster_manifest(tc)
        assert man == jg.cluster_manifest(jc)
        assert tg.cluster_from_manifest(json.loads(json.dumps(man))) == tc
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for attr in ("n", "m", "is_uniform", "dtype_bytes", "min_flops", "min_link_bw",
                     "min_agg_bw", "max_sync_latency", "link_bw", "agg_bw", "sync_latency",
                     "flops"):
            assert getattr(tc, attr) == getattr(jc, attr), attr
    for name, p in tg.PROFILES.items():
        assert tg.profile_manifest(p) == jg.profile_manifest(jg.PROFILES[name])
        assert tg.profile_from_manifest(tg.profile_manifest(p)) == p
    assert sorted(tg.CLUSTER_ALIASES) == sorted(jg.CLUSTER_ALIASES)


@pytest.mark.parametrize("spec,grid", [
    ("pi3x3+jetson", (2, 2)), ("pi3x4", (2, 2)), ("pi3x3", (2, 2)), ("pi3x5", (2, 2)),
    ("bogus", (2, 2)), ("pi3x3+bogus", (2, 2)), ("jetson-edge+tpux2", (1, 3)), ("x2", (1, 2)),
    ("", (1, 1)),
])
def test_parse_cluster_spec_results_and_errors_equal_reference(spec, grid):
    ref, port = _both("parse_cluster_spec", spec, *grid)
    _same(ref, port)


def test_device_list_helpers_equal_reference():
    for spec, grid in (("pi3x3+jetson", (2, 2)), ("pi3x4", (2, 2)), ("jetsonx6", (2, 3))):
        jc, tc = jg.parse_cluster_spec(spec, *grid), tg.parse_cluster_spec(spec, *grid)
        for dev in ("jetson", "pi3", "pi3-core", 0, 3, 7, "tpu", -1):
            ref, port = _both("drop_device", jc, dev)
            _same(ref, port)
        for dev in ("tpu", "jetson-edge", "bogus"):
            ref, port = _both("add_device", jc, dev)
            _same(ref, port)
        ref, port = _both("pack_devices", "x", list(jc.devices))
        _same(ref, port)
    _same(*_both("drop_device", jg.parse_cluster_spec("pi3", 1, 1), 0))
    _same(*_both("pack_devices", "empty", []))


# ---------------------------------------------------------------------------
# geometry, codec pricing, stage helpers
# ---------------------------------------------------------------------------


def test_split_1d_equals_reference():
    for own in range(1, 12):
        for lo in range(0, 5):
            for hi in range(0, 5):
                for kernel in (1, 2, 3, 5):
                    for stride in (1, 2):
                        ref = jsp.split_1d(own, lo, hi, kernel, stride)
                        port = tsp.split_1d(own, lo, hi, kernel, stride)
                        if ref is None:
                            assert port is None
                        else:
                            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
                            assert (port.n_lo, port.n_hi) == (ref.n_lo, ref.n_hi)


def test_codec_pricing_equals_reference():
    for spec in (None, "none", "int8", "topk:0.1", "topk:0.5", "topk:5", "topk:1.0",
                 "topk:0", "topk:-1", "topk:abc", "bogus"):
        try:
            ref = jcomp.get_codec(spec)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tcomp.get_codec(spec)
            assert str(got.value) == str(e)
            continue
        port = tcomp.get_codec(spec)
        assert (port is None) == (ref is None)
        if ref is None:
            continue
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for n in (1, 7, 100, 3000, 10 ** 6):
            assert port._k_eff(n) == ref._k_eff(n)
            for db in (2, 4):
                assert port.wire_bytes(n, db) == ref.wire_bytes(n, db)
                assert tcomp.modeled_wire_bytes(n, db, spec) == \
                    jcomp.modeled_wire_bytes(n, db, spec)
                assert tcomp.modeled_wire_bytes(n + 0.5, db, spec) == \
                    jcomp.modeled_wire_bytes(n + 0.5, db, spec)
    for n in (1, 16, 17, 64, 65, 128, 129, 256, 4096):
        for block in (256, 64, 32):
            assert tcomp._auto_block(n, block) == jcomp._auto_block(n, block)
    assert tcomp.modeled_wire_bytes(10, 4, None) == jcomp.modeled_wire_bytes(10, 4, None)


def test_codec_executor_is_not_ported_yet():
    """The codec executor is ported (ROADMAP A.14): every codec round-trips
    a tile grid per tile - int8 within half a quantisation step of each
    tile's own block scale, full top-k exactly - and priced payloads are
    what the encoder ships."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 2, 3, 40)).astype(np.float32))
    int8 = tcomp.get_codec("int8")
    q, scale = int8.encode(x, tiles=2)
    assert q.dtype == torch.int8 and tuple(q.shape) == (2, 2, 1, 128)     # 120 values: block 128
    y = int8.decode((q, scale), x.shape, x.dtype, tiles=2)
    step = scale.repeat_interleave(128, dim=-1)[..., :120].reshape(x.shape)
    assert bool(((y - x).abs() <= step / 2 + 1e-7).all())
    assert int8.wire_bytes(120, 4) == q[0, 0].numel() - 8                    # 1 B/value, pad not priced
    full = tcomp.get_codec("topk:120")
    assert torch.equal(full.decode(full.encode(x, tiles=2), x.shape, x.dtype, tiles=2), x)
    half = tcomp.get_codec("topk:0.5")
    vals, idx = half.encode(x, tiles=2)
    assert tuple(vals.shape) == (2, 2, 60) and half.wire_bytes(120, 4) == vals[0, 0].numel() * 8


def test_stage_helpers_equal_reference():
    for s in range(0, 5):
        for mb in range(0, 5):
            ref, port = _both("bubble_fraction", s, mb)
            _same(ref, port)
    for n in (1, 2, 3, 4):
        for m in (1, 2, 3, 4):
            for tail in (1, 2, 5, 16):
                assert tg.feasible_stage_counts(n, m, tail) == jg.feasible_stage_counts(n, m, tail)
                for arg in (None, "auto", 2, 3, 4, 1, 0, True, "x", 2.0):
                    _same(*_both("check_pipeline_arg", arg, n, m, tail))
    for arg in (None, "auto", 0, 4, 8, 9, -1, "x", 2.5):
        _same(*_both("check_crossover_arg", arg, 8))
    layers = jax_yolo_layers()[:16]
    ext = jg._map_extents((416, 416), layers)
    for hw in (jg.JETSON_EDGE_PROFILE, jg.TPU_V5E_PROFILE):
        for start, stages in ((8, 2), (4, 4), (12, 4), (14, 3)):
            for codec in CODECS:
                ref, port = _both("balance_stages", layers, ext, start, 16, stages,
                                  stage_size=2, hw=hw, batch=8, wire_codec=codec)
                _same(ref, port)
        for first in (True, False):
            g = (10, 13, "pipeline")
            jr = jg.stage_cost(layers, ext, jt.Group(*g), stage_size=2, hw=hw, batch=8,
                               first_stage=first, wire_codec="int8")
            tr = tg.stage_cost(_port_layers(layers), ext, tt.Group(*g), stage_size=2,
                               hw=tg.HardwareProfile(**dataclasses.asdict(hw)), batch=8,
                               first_stage=first, wire_codec="int8")
            assert tr == jr


# ---------------------------------------------------------------------------
# a seeded sweep of random small stacks
# ---------------------------------------------------------------------------


def _random_stack(rng):
    layers, ch = [], int(rng.choice([1, 3, 4]))
    for _ in range(int(rng.integers(2, 8))):
        kind = rng.integers(0, 4)
        if kind == 0:
            layers.append(jsp.LayerDef(2, 2, ch, ch, pool=True, act="linear"))
        else:
            cout = int(rng.choice([2, 5, 8, 16]))
            k = int(rng.choice([1, 3, 5]))
            stride = int(rng.choice([1, 1, 2])) if k > 1 else 1
            bn = bool(rng.integers(0, 2))
            layers.append(jsp.LayerDef(k, stride, ch, cout, batch_norm=bn, use_bias=not bn))
            ch = cout
    return layers


def test_random_stacks_equal_reference():
    rng = np.random.default_rng(20261017)
    chosen = set()
    for case in range(50):
        layers = _random_stack(rng)
        L = len(layers)
        input_hw = (int(rng.choice([16, 32, 48, 64])),) * 2
        n, m = GRIDS[case % len(GRIDS)]
        hw = jg.HardwareProfile(
            f"rand{case}", flops=float(10 ** rng.uniform(7, 13)),
            link_bw=float(10 ** rng.uniform(6, 10)), sync_latency=float(10 ** rng.uniform(-6, -2)),
            agg_bw=float(10 ** rng.uniform(6, 10)), dtype_bytes=int(rng.choice([2, 4])),
        )
        batch = int(rng.integers(1, 9))
        codec = CODECS[case % 3]
        schedule = SCHEDULES[case % 2]
        cuts = sorted(set(int(c) for c in rng.integers(1, L, size=int(rng.integers(0, L)))))
        bounds = [0] + cuts + [L]
        spec = [(a, b - 1) for a, b in zip(bounds, bounds[1:])]
        for groups in (Gs(spec), Gs(spec[:-1] + [(spec[-1][0], spec[-1][1], "data")])):
            ref, port = _both("profile_cost", input_hw, layers, groups, n, m, hw, batch,
                              schedule, wire_codec=codec)
            assert port == ref, case
            ref, port = _both("peak_device_memory", input_hw, layers, groups, n, m, batch=batch,
                              dtype_bytes=hw.dtype_bytes)
            assert port == ref, case
        ref, port = _both("optimize_grouping", input_hw, layers, n, m, hw, batch,
                          schedule=schedule, wire_codec=codec)
        _same(ref, port)
        ref, port = _both("optimize_grouping", input_hw, layers, n, m, hw, batch,
                          crossover="auto", wire_codec=codec)
        _same(ref, port)
        if not isinstance(ref, tuple):
            chosen.add(len(ref))
    assert len(chosen) > 2, "the sweep should reach groupings of several sizes"


# ---------------------------------------------------------------------------
# the card run's auto plans
# ---------------------------------------------------------------------------


def _chip_smoke_constant(name):
    path = os.path.join(REPO, "chip_smoke.py")
    for node in ast.parse(open(path).read(), path).body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == name
                                                 for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"chip_smoke.py defines no {name}")


def test_chip_smoke_auto_groups_are_the_references_choice():
    """``AUTO_GROUPS_416``: YOLOv2-16 (BN) at 416x416 on 2x2, batch 8, sync,
    per profile - what the reference's DP chooses, what the port's DP
    chooses, and what the card run checks its plans against."""
    want = _chip_smoke_constant("AUTO_GROUPS_416")
    assert sorted(want) == PROFILE_NAMES
    layers = jax_yolo_layers(batch_norm=True)
    for name in PROFILE_NAMES:
        for batch in (8, 1):
            ref = jg.optimize_grouping((416, 416), layers, 2, 2, jg.PROFILES[name], batch=batch)
            port = tg.optimize_grouping((416, 416), _port_layers(layers), 2, 2,
                                        tg.PROFILES[name], batch=batch)
            assert [(g.start, g.end) for g in ref] == [tuple(g) for g in want[name]]
            assert _key(port) == _key(ref)
