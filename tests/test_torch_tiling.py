"""The port's copy of the tile geometry (``repro_torch.core.tiling``) equals
the reference (``repro.core.tiling``) on the cases of
tests/test_tiling_geometry.py and tests/test_partition.py, case by case."""
import dataclasses
import itertools

import pytest

from repro.core import tiling as jt
from repro_torch.core import tiling as tt


def _plain(v):
    """Dataclasses -> dicts, sequences -> lists, so results of the two
    modules (distinct classes) compare by value."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def _both(fn_name, *args, conv=lambda mod, a: a, **kw):
    """Call ``fn_name`` in both modules on converted args; return both
    results, or both exception types."""
    out = []
    for mod in (jt, tt):
        try:
            out.append(_plain(getattr(mod, fn_name)(*conv(mod, args), **kw)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def _spans(mod, args):
    return [mod.Span(*a) if isinstance(a, tuple) else a for a in args]


def _convs(mod, specs):
    return [mod.ConvSpec(*s) for s in specs]


SPANS = [(0, 0), (3, 9), (17, 40), (0, 63)]
CONVS = [(1, 1), (2, 2), (3, 1), (3, 2), (5, 1), (7, 2)]


@pytest.mark.parametrize("span,conv", list(itertools.product(SPANS, CONVS)))
def test_eq1_eq2_regions(span, conv):
    for fn in ("dependent_region_1d", "forward_region_1d"):
        a, b = _both(fn, span, conv,
                     conv=lambda mod, a: (mod.Span(*a[0]), mod.ConvSpec(*a[1])))
        assert a == b


STACKS = [
    [(3, 1)], [(3, 1), (2, 2)], [(3, 1), (2, 2), (3, 1), (2, 2)],
    [(5, 2), (1, 1), (3, 1)], [(7, 2), (3, 2), (3, 1), (1, 1), (3, 1)],
]


@pytest.mark.parametrize("stack", STACKS, ids=[str(s) for s in STACKS])
def test_group_halo_and_input_region(stack):
    for fn in ("group_halo_width", "cumulative_stride"):
        a, b = _both(fn, stack, conv=lambda mod, a: (_convs(mod, a[0]),))
        assert a == b
    a, b = _both("group_input_region_1d", (2, 5), stack,
                 conv=lambda mod, a: (mod.Span(*a[0]), _convs(mod, a[1])))
    assert a == b


@pytest.mark.parametrize("extent,parts", [(1, 1), (7, 2), (16, 4), (13, 5), (3, 4), (256, 16)])
def test_partitions(extent, parts):
    for fn, args in (("partition_1d", (extent, parts)), ("even_bounds_1d", (extent, parts)),
                     ("partition_grid", (extent, extent + 1, parts, max(1, parts - 1)))):
        a, b = _both(fn, *args)
        assert a == b


@pytest.mark.parametrize("n_layers,gsize", [(1, 1), (6, 2), (7, 3), (12, 5)])
def test_grouping_profiles(n_layers, gsize):
    for fn, args in (("no_grouping", (n_layers,)), ("single_group", (n_layers,)),
                     ("uniform_grouping", (n_layers, gsize))):
        assert _both(fn, *args)[0] == _both(fn, *args)[1]
    bad = [(0, n_layers)]
    a, b = _both("validate_profile", bad, n_layers,
                 conv=lambda mod, a: ([mod.Group(*g) for g in a[0]], a[1]))
    assert a == b and a[0] == "ValueError"


PROFILE_CASES = [
    [(0, 1), (2, 3, "data")],
    [(0, 1, "data"), (2, 3)],
    [(0, 1), (2, 3, "pipeline")],
    [(0, 1, "pipeline"), (2, 3, "data")],
    [(0, 3, "bogus")],
    [(0, 1), (3, 3)],
]


@pytest.mark.parametrize("profile", PROFILE_CASES, ids=[str(p) for p in PROFILE_CASES])
def test_validate_profile_modes(profile):
    conv = lambda mod, a: ([mod.Group(*g) for g in a[0]], a[1])
    assert _both("validate_profile", profile, 4, conv=conv)[0] == \
        _both("validate_profile", profile, 4, conv=conv)[1]
    for fn in ("crossover_of", "pipeline_first_of"):
        a, b = _both(fn, profile, conv=lambda mod, a: ([mod.Group(*g) for g in a[0]],))
        assert a == b


def _yolo_head(mod, n=6):
    # the YOLOv2 head as ConvSpecs (tests/test_tiling_geometry.py:_yolo_head)
    spec = [(3, 1, 3, 32), (2, 2, 32, 32, True), (3, 1, 32, 64), (2, 2, 64, 64, True),
            (3, 1, 64, 128), (1, 1, 128, 64)]
    return [mod.ConvSpec(k, s, ci, co, *p) for k, s, ci, co, *p in spec[:n]]


@pytest.mark.parametrize("grid,groups_of", list(itertools.product([(2, 2), (4, 4), (2, 4)], [1, 2, 3, 6])))
def test_build_tiling_plan_and_metrics(grid, groups_of):
    n, m = grid
    res = []
    for mod in (jt, tt):
        layers = _yolo_head(mod)
        plan = mod.build_tiling_plan((64, 64), layers, n, m,
                                     mod.uniform_grouping(len(layers), groups_of))
        res.append((_plain(plan), mod.halo_bytes_per_group(plan, layers),
                    mod.redundant_flops(plan, layers),
                    mod.peak_tile_activation_elems(plan, layers),
                    _plain(plan.extent_spans(2))))
    assert res[0] == res[1]


PARTITIONS = [((0, 4, 7), (0, 3, 5, 7)), ((0, 12, 16), (0, 12, 16)), ((1, 4), (0, 4)),
              ((0, 4, 4), (0, 4)), ((0, 16, 32), (0, 8, 16, 24, 32))]


@pytest.mark.parametrize("rb,cb", PARTITIONS, ids=[str(p) for p in PARTITIONS])
def test_tile_partition(rb, cb):
    res = []
    for mod in (jt, tt):
        try:
            p = mod.TilePartition(rb, cb)
        except ValueError as e:
            res.append(str(e))
            continue
        res.append((p.n, p.m, p.extent, p.row_sizes, p.col_sizes, p.is_uniform,
                    _plain(p.tile_box(p.n - 1, p.m - 1)),
                    _plain(mod.TilePartition.from_sizes(p.row_sizes, p.col_sizes)),
                    _plain(mod.TilePartition.even(*p.extent, p.n, p.m)),
                    mod.dedup_axis_shapes(p.col_sizes)))
    assert res[0] == res[1]


BOUNDS_CASES = [
    ("push_bounds_1d", ((0, 8, 16), 2, 8)),
    ("push_bounds_1d", ((0, 7, 16), 2, 8)),
    ("push_bounds_1d", ((0, 4, 8, 16), 4, 2)),
    ("pull_bounds_1d", ((0, 4, 8), 2, 16)),
    ("pull_bounds_1d", ((0, 1, 2), 2, 2)),
    ("propagate_bounds", ((0, 18, 34), [1, 2, 1], [34, 34, 17, 17])),
    ("propagate_bounds", ((0, 18, 32), [1, 2, 1], [34, 34, 17, 17])),
    ("even_bounds_from_output", ([1, 2, 1, 2], [52, 52, 26, 26, 13], 2)),
    ("derive_axis_bounds", (None, [1, 2, 1, 2], [52, 52, 26, 26, 13], 2)),
    ("derive_axis_bounds", ((0, 24, 52), [1, 2, 1, 2], [52, 52, 26, 26, 13], 2)),
    ("bounds_sizes", ((0, 3, 10, 11),)),
    ("spans_from_bounds", ((0, 3, 10, 11),)),
]


@pytest.mark.parametrize("fn,args", BOUNDS_CASES, ids=[f"{f}{a}" for f, a in BOUNDS_CASES])
def test_bounds_math(fn, args):
    a, b = _both(fn, *args)
    assert a == b


def test_partitioned_tiling_plan():
    res = []
    for mod in (jt, tt):
        layers = [mod.ConvSpec(3, 1, 8, 8), mod.ConvSpec(2, 2, 8, 8, pool=True)]
        plan = mod.build_tiling_plan((16, 16), layers, 2, 2,
                                     partition=mod.TilePartition((0, 12, 16), (0, 12, 16)))
        res.append(_plain(plan))
    assert res[0] == res[1]


def test_apply_crossover():
    for c in (None, 0, 2, 1):
        conv = lambda mod, a: ([mod.Group(0, 1), mod.Group(2, 3)], a[0])
        a, b = _both("apply_crossover", c, conv=conv)
        assert a == b
