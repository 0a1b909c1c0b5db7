"""The port's training slice against the JAX reference.

- ``make_tiled_loss`` and ``make_deferred_grad_step`` on the 2x2 virtual
  mesh (grouped and per-layer plans, BN on and off, 1 and 2 microbatches,
  both conv backends on the CPU) against JAX's untiled ``reference_loss``
  and ``jax.grad`` in process, and against JAX's own 2x2
  ``make_deferred_grad_step`` with ``backend="pallas"`` in a subprocess with
  4 fake devices.  Bar of ``scripts/check_pipeline.py:102-103``: loss within
  1e-5 x max(1, |ref|), every grad within 1e-5.
- ``make_train_step``: 3 steps with SGD and AdamW, ``grad_accum`` 2, against
  JAX's ``make_train_step`` on the same batches, in process on 1x1 and by
  the subprocess on 2x2: params within 1e-5 (AdamW: see
  ``ADAM_WELL_CONDITIONED``).
- int8 error feedback: ``compress_with_feedback`` on identical inputs within
  1e-6; a 3-step int8 run within ``INT8_PARAM_TOL`` (see there).
- optimizers and schedules against the reference's, run_training's retry
  count, and the launcher on the CPU (unported flags name their ROADMAP
  item).
"""
import dataclasses
import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import TrainConfig as JTrain
from repro.core import fusion as jfu
from repro.core import spatial as jsp
from repro.core.tiling import Group as JGroup
from repro.launch.mesh import make_tile_mesh as jax_mesh
from repro.models.tiled_cnn import TiledCNNArch as JArch
from repro.models.yolo import l2_loss_local as jax_l2
from repro.models.yolo import yolov2_16_layers as jax_yolo_layers
from repro.optim import compression as jcomp
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train import trainer as jtrain
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.core import fusion as tfu
from repro_torch.core import spatial as tsp
from repro_torch.core.tiling import Group
from repro_torch.interop import params_from_jax
from repro_torch.launch.mesh import make_tile_mesh
from repro_torch.models.tiled_cnn import TiledCNNArch
from repro_torch.models.yolo import l2_loss_local, make_yolo_tiled_arch
from repro_torch.optim import compression as tcomp
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.runtime.driver import DriverConfig, run_training
from repro_torch.train.trainer import TrainState, make_train_step

LOSS_RTOL = 1e-5       # x max(1, |ref|)   scripts/check_pipeline.py:102
GRAD_ATOL = 1e-5       # every grad leaf   scripts/check_pipeline.py:103
PARAM_ATOL = 1e-5      # params after N trainer steps (ROADMAP A.8)
# int8 error feedback rounds (grad + error) / scale to the nearest of 255
# levels per 256-value block, so a ~1e-7 grad difference between the
# packages can move a value that sits on a rounding boundary by one level,
# scale = max|block| / 127, and the error buffer carries it into the next
# step.  One level moves a param by lr * scale: with lr 1e-3 and
# max|g| < 0.1 here that is < 1e-6 per step, so even a few flips stay
# inside the same 1e-5 as the uncompressed trainer (measured: 4.5e-8).
INT8_PARAM_TOL = 1e-5
# AdamW divides each moment by sqrt(second moment) + 1e-8.  Where a grad
# element is itself ~1e-8 (a few in 1e5 here; median |g| ~1e-3), a 4e-9
# difference between the packages' grads - far inside GRAD_ATOL - moves
# that element's step by a sizeable part of lr.  Such elements (second-moment
# root below ADAM_WELL_CONDITIONED) are held to Adam's own step bound
# (|step| <= 1 + weight decay * |p| per step) instead of PARAM_ATOL, and
# they must stay rare; every other element is held to PARAM_ATOL.
ADAM_WELL_CONDITIONED = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Small shapes: one intra-op thread each, so parallel test workers do
    not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)

NARROW = [
    jsp.LayerDef(3, 1, 3, 8, act="leaky", batch_norm=True, use_bias=False),
    jsp.LayerDef(2, 2, 8, 8, pool=True, act="linear"),
    jsp.LayerDef(3, 1, 8, 6, act="relu"),
    jsp.LayerDef(3, 2, 6, 5, act="leaky"),            # stride-2 conv: strided dgrad
    jsp.LayerDef(1, 1, 5, 4, act="linear", batch_norm=True),
]

CASES = {
    # name: (jax layers, groups)
    "yolo4-none": (jax_yolo_layers()[:4], None),
    "yolo4-grouped": (jax_yolo_layers()[:4], [(0, 1), (2, 3)]),
    "yolo4-nobn-grouped": (jax_yolo_layers(batch_norm=False)[:4], [(0, 1), (2, 3)]),
    "narrow-grouped": (NARROW, [(0, 2), (3, 4)]),
}
HW = (32, 32)


def _port(layers):
    return [tsp.LayerDef(**dataclasses.asdict(l)) for l in layers]


def _np_params(layers, seed=0):
    params = jsp.init_stack_params(jax.random.PRNGKey(seed), layers)
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _data(layers, mb, b, seed=1):
    out_hw = HW
    for l in layers:
        out_hw = (l.out_extent(out_hw[0]), l.out_extent(out_hw[1]))
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((mb, b, *HW, 3)).astype(np.float32)
    ts = (0.05 * rng.standard_normal((mb, b, *out_hw, layers[-1].out_channels))).astype(np.float32)
    return xs, ts


@functools.lru_cache(maxsize=None)
def _jax_reference(case: str, mb: int):
    """JAX untiled oracle of the deferred step: per-microbatch forward (BN
    statistics per microbatch), summed squared error over the global
    count, and its jax.grad."""
    layers, _ = CASES[case]
    params = _np_params(layers)
    xs, ts = _data(layers, mb, 2)
    plan = jfu.build_stack_plan(HW, layers, 1, 1)

    def batch_loss(p):
        s = c = 0.0
        for i in range(mb):
            y = jfu.reference_forward(p, xs[i], plan)
            si, ci = jax_l2(y, ts[i])
            s, c = s + si, c + ci
        return s / c

    loss, grads = jax.value_and_grad(batch_loss)(params)
    return params, xs, ts, float(loss), [{k: np.asarray(v) for k, v in g.items()} for g in grads]


def _plan(case, backend):
    layers, groups = CASES[case]
    g = None if groups is None else [Group(s, e) for s, e in groups]
    return tfu.build_stack_plan(HW, _port(layers), 2, 2, g, backend=backend)


def _assert_grads(grads, want, atol=GRAD_ATOL):
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k].detach().numpy(), w[k], atol=atol, err_msg=k)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_deferred_grad_step_2x2_matches_jax_untiled(case, backend, mb):
    params, xs, ts, ref_loss, ref_grads = _jax_reference(case, mb)
    step = tfu.make_deferred_grad_step(_plan(case, backend), make_tile_mesh(2, 2, "cpu"),
                                       l2_loss_local, microbatches=mb)
    loss, grads = step(params_from_jax(params, "cpu"), xs, ts)
    assert abs(float(loss) - ref_loss) < LOSS_RTOL * max(1.0, abs(ref_loss))
    _assert_grads(grads, ref_grads)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_loss_2x2_matches_jax_untiled(case, backend):
    params, xs, ts, ref_loss, ref_grads = _jax_reference(case, 1)
    loss_fn = tfu.make_tiled_loss(_plan(case, backend), make_tile_mesh(2, 2, "cpu"), l2_loss_local)
    tp = [{k: v.requires_grad_(True) for k, v in p.items()} for p in params_from_jax(params, "cpu")]
    loss = loss_fn(tp, xs[0], ts[0])
    assert abs(loss.item() - ref_loss) < LOSS_RTOL * max(1.0, abs(ref_loss))
    leaves = [v for p in tp for v in p.values()]
    g = iter(torch.autograd.grad(loss, leaves))
    _assert_grads([{k: next(g) for k in p} for p in tp], ref_grads)
    # the port's own untiled reference agrees as well
    ref = tfu.reference_loss(params_from_jax(params, "cpu"), torch.from_numpy(xs[0]),
                             torch.from_numpy(ts[0]), _plan(case, backend), l2_loss_local)
    assert abs(float(ref) - ref_loss) < LOSS_RTOL * max(1.0, abs(ref_loss))


def test_training_entry_points_refuse_serve_plans_and_bad_microbatches():
    plan = _plan("yolo4-none", "torch")
    mesh = make_tile_mesh(2, 2, "cpu")
    for make in (tfu.make_tiled_loss, tfu.make_deferred_grad_step):
        with pytest.raises(ValueError, match="forward-only"):
            make(plan.inference_twin(), mesh, l2_loss_local)
    params, xs, ts, *_ = _jax_reference("yolo4-none", 2)
    step = tfu.make_deferred_grad_step(plan, mesh, l2_loss_local, microbatches=1)
    with pytest.raises(ValueError, match="microbatches=1"):
        step(params_from_jax(params, "cpu"), xs, ts)
    for field, value, item in (("stages", ((0, 2),), "A.13"), ("crossover", 2, "A.11"),
                               ("wire_codec", "int8", "A.14")):
        with pytest.raises(NotImplementedError, match=item):
            tfu.make_tiled_loss(dataclasses.replace(plan, **{field: value}), mesh, l2_loss_local)


def test_bn_tiled_statistics_cover_core_positions_once():
    """A one-layer BN stack on 2x2 tiles with a halo-carrying group: the
    tiled forward equals the untiled training forward (batch statistics
    over the whole map, halos not counted twice)."""
    layers = [jsp.LayerDef(3, 1, 3, 4, act="linear", batch_norm=True, use_bias=False),
              jsp.LayerDef(3, 1, 4, 4, act="leaky", batch_norm=True, use_bias=False)]
    params = _np_params(layers)
    x = np.random.default_rng(2).standard_normal((3, 16, 16, 3)).astype(np.float32)
    want = np.asarray(jsp.stack_reference(x, params, layers))
    plan = tfu.build_stack_plan((16, 16), _port(layers), 2, 2, [Group(0, 1)])
    got = tfu.make_tiled_forward(plan, make_tile_mesh(2, 2, "cpu"))(params_from_jax(params, "cpu"), x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---------------------------------------------------------------------------
# trainer: port vs JAX make_train_step
# ---------------------------------------------------------------------------

TRAIN_LAYERS = jax_yolo_layers()[:4]
TRAIN_GROUPS = [(0, 1), (2, 3)]


def _batch(step, seed=0, b=4):
    """The launcher's make_batch recipe at 32x32, depth 4 (target 8x8x64)."""
    r = np.random.default_rng([seed, step])
    return {"x": r.standard_normal((b, *HW, 3), np.float32),
            "t": 0.05 * r.standard_normal((b, 8, 8, 64), np.float32)}


def _port_train(params, opt, n, grid, compress=None, steps=3, backend="cuda"):
    g = [Group(s, e) for s, e in TRAIN_GROUPS]
    plan = tfu.build_stack_plan(HW, _port(TRAIN_LAYERS), grid, grid, g, backend=backend)
    arch = TiledCNNArch(plan=plan, mesh=make_tile_mesh(grid, grid, "cpu"), loss_local=l2_loss_local)
    tcfg = TrainConfig(lr=1e-3, optimizer=opt, warmup=0, steps=steps, grad_compression=compress)
    init_state, step = make_train_step(arch, ParallelConfig(grad_accum=2), tcfg)
    state = init_state(0)
    state = state._replace(params=params_from_jax(params, "cpu"))
    opt_states = []
    for s in range(n):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in _batch(s).items()})
        opt_states.append(state.opt)
    assert state.step == n and set(m) == {"loss", "grad_norm", "lr"}
    return state, opt_states


def _jax_train(opt, n, compress=None, steps=3):
    g = [JGroup(s, e) for s, e in TRAIN_GROUPS]
    plan = jfu.build_stack_plan(HW, TRAIN_LAYERS, 1, 1, g)
    arch = JArch(plan=plan, mesh=jax_mesh(1, 1), loss_local=jax_l2)
    tcfg = JTrain(lr=1e-3, optimizer=opt, warmup=0, steps=steps, grad_compression=compress)
    init_state, step = jtrain.make_train_step(arch, JParallel(grad_accum=2), tcfg)
    state = init_state(jax.random.PRNGKey(0))
    params0 = [{k: np.asarray(v) for k, v in p.items()} for p in state.params]
    step = jax.jit(step)
    for s in range(n):
        state, _ = step(state, _batch(s))
    return params0, [{k: np.asarray(v) for k, v in p.items()} for p in state.params]


def _max_param_err(state, want):
    return max(float(np.max(np.abs(p[k].numpy() - w[k]))) for p, w in zip(state.params, want)
               for k in w)


def _assert_params(state, opt_states, want, opt, lr=1e-3):
    if opt != "adamw":
        assert _max_param_err(state, want) < PARAM_ATOL
        return
    ill = None          # elements whose second-moment root fell below the bar at any step
    for st in opt_states:
        bc2 = 1 - 0.95 ** st["t"]
        step_ill = [{k: np.sqrt(v[k].numpy() / bc2) < ADAM_WELL_CONDITIONED for k in v}
                    for v in st["v"]]
        ill = step_ill if ill is None else [{k: a[k] | b[k] for k in a} for a, b in zip(ill, step_ill)]
    n_ill = n_all = 0
    for p, m, w in zip(state.params, ill, want):
        for k in w:
            d = np.abs(p[k].numpy() - w[k])
            assert np.all(d[~m[k]] < PARAM_ATOL), (k, float(d[~m[k]].max()))
            bound = 2 * len(opt_states) * lr * (1 + 0.1 * np.abs(w[k][m[k]]))
            assert np.all(d[m[k]] <= bound), k
            n_ill += int(m[k].sum())
            n_all += m[k].size
    assert n_ill <= 1e-3 * n_all, (n_ill, n_all)


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_train_step_1x1_matches_jax_trainer(opt):
    params0, want = _jax_train(opt, 3)
    state, opt_states = _port_train(params0, opt, 3, grid=1)
    _assert_params(state, opt_states, want, opt)
    # and the params did move
    assert max(float(np.max(np.abs(w[k] - p[k]))) for p, w in zip(params0, want) for k in w) > 1e-4


def test_int8_compress_with_feedback_matches_jax():
    rng = np.random.default_rng(4)
    grads = [{"w": rng.standard_normal((3, 3, 5, 7)).astype(np.float32) * 1e-3,
              "b": rng.standard_normal(7).astype(np.float32)},
             {"w": rng.standard_normal((700,)).astype(np.float32)}]
    err = [{k: rng.standard_normal(v.shape).astype(np.float32) * 1e-5 for k, v in g.items()}
           for g in grads]
    jg, jst = jcomp.compress_with_feedback(grads, jcomp.CompressionState(err))
    tg, tst = tcomp.compress_with_feedback(
        [{k: torch.from_numpy(v) for k, v in g.items()} for g in grads],
        tcomp.CompressionState([{k: torch.from_numpy(v) for k, v in e.items()} for e in err]))
    for a, b in ((tg, jg), (tst.error, jst.error)):
        for pa, pb in zip(a, b):
            for k in pb:
                np.testing.assert_allclose(pa[k].numpy(), np.asarray(pb[k]), atol=1e-6)
    q, s = tcomp.int8_compress(torch.from_numpy(grads[1]["w"]))
    jq, js = jcomp.int8_compress(jnp.asarray(grads[1]["w"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert tcomp.init_error(tg).error[0]["w"].dtype == torch.float32


def test_train_step_int8_matches_jax_trainer():
    params0, want = _jax_train("sgd", 3, compress="int8")
    state, _ = _port_train(params0, "sgd", 3, grid=1, compress="int8")
    assert state.ef is not None
    assert _max_param_err(state, want) < INT8_PARAM_TOL


_JAX_2X2 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.configs.base import ParallelConfig, TrainConfig
    from repro.core.fusion import build_stack_plan, make_deferred_grad_step
    from repro.core.tiling import Group
    from repro.launch.mesh import make_tile_mesh
    from repro.models.tiled_cnn import TiledCNNArch
    from repro.models.yolo import l2_loss_local, yolov2_16_layers
    from repro.train.trainer import make_train_step
    layers = yolov2_16_layers()[:4]
    mesh = make_tile_mesh(2, 2)
    groups = [Group(0, 1), Group(2, 3)]
    plan = build_stack_plan((32, 32), layers, 2, 2, groups, backend="pallas")
    arch = TiledCNNArch(plan=plan, mesh=mesh, loss_local=l2_loss_local)
    out = {}
    for opt in ("sgd", "adamw"):
        tcfg = TrainConfig(lr=1e-3, optimizer=opt, warmup=0, steps=3)
        init_state, step = make_train_step(arch, ParallelConfig(grad_accum=2), tcfg)
        state = init_state(jax.random.PRNGKey(0))
        if opt == "sgd":
            params = state.params
            r = np.random.default_rng(9)
            xs = r.standard_normal((2, 2, 32, 32, 3)).astype(np.float32)
            ts = (0.05 * r.standard_normal((2, 2, 8, 8, 64))).astype(np.float32)
            loss, grads = jax.jit(make_deferred_grad_step(plan, mesh, l2_loss_local,
                                                          microbatches=2))(params, xs, ts)
            out.update(xs=xs, ts=ts, loss=np.asarray(loss))
            for i, p in enumerate(params):
                for k, v in p.items():
                    out[f"p{i}_{k}"] = np.asarray(v)
                    out[f"g{i}_{k}"] = np.asarray(grads[i][k])
        step = jax.jit(step)
        for s in range(3):
            r = np.random.default_rng([0, s])
            batch = {"x": r.standard_normal((4, 32, 32, 3), np.float32),
                     "t": 0.05 * r.standard_normal((4, 8, 8, 64), np.float32)}
            state, _ = step(state, batch)
        for i, p in enumerate(state.params):
            for k, v in p.items():
                out[f"{opt}{i}_{k}"] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def jax_2x2(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax2x2") / "jax_pallas_2x2_train.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", _JAX_2X2, str(out)], env=env, check=True, timeout=600)
    d = np.load(out)

    def tree(prefix):
        t = [{} for _ in TRAIN_LAYERS]
        for key in d.files:
            if key.startswith(prefix) and key[len(prefix)].isdigit():
                i, k = key[len(prefix):].split("_", 1)
                t[int(i)][k] = d[key]
        return t

    return d, tree


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_deferred_grad_step_matches_jax_pallas_2x2_subprocess(jax_2x2, backend):
    d, tree = jax_2x2
    g = [Group(s, e) for s, e in TRAIN_GROUPS]
    plan = tfu.build_stack_plan(HW, _port(TRAIN_LAYERS), 2, 2, g, backend=backend)
    step = tfu.make_deferred_grad_step(plan, make_tile_mesh(2, 2, "cpu"), l2_loss_local,
                                       microbatches=2)
    loss, grads = step(params_from_jax(tree("p"), "cpu"), d["xs"], d["ts"])
    ref = float(d["loss"])
    assert abs(float(loss) - ref) < LOSS_RTOL * max(1.0, abs(ref))
    _assert_grads(grads, tree("g"))


@pytest.mark.parametrize("opt", ["sgd", "adamw"])
def test_train_step_2x2_matches_jax_pallas_trainer_subprocess(jax_2x2, opt):
    _, tree = jax_2x2
    state, opt_states = _port_train(tree("p"), opt, 3, grid=2)
    _assert_params(state, opt_states, tree(opt), opt)


# ---------------------------------------------------------------------------
# optimizers, schedules, driver, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 3, 10, 60, 99, 150])
def test_schedules_match_jax(step):
    assert tsched.cosine_schedule(step, 10, 100, 3e-4) == pytest.approx(
        float(jsched.cosine_schedule(jnp.int32(step), 10, 100, 3e-4)), rel=1e-6)
    assert tsched.linear_warmup(step, 50, 1e-3) == pytest.approx(
        float(jsched.linear_warmup(jnp.int32(step), 50, 1e-3)), rel=1e-6)


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_optimizer_updates_match_jax(name):
    rng = np.random.default_rng(6)
    params = [{"w": rng.standard_normal((3, 4)).astype(np.float32)}, {},
              {"w": rng.standard_normal(5).astype(np.float32)}]
    jo, to = jopt.make_optimizer(name, weight_decay=0.1), topt.make_optimizer(name, weight_decay=0.1)
    jp, js = params, jo.init(params)
    tp = [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]
    ts = to.init(tp)
    for i in range(3):
        g = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()} for p in params]
        jp, js = jo.update(g, js, jp, 1e-2)
        tp, ts = to.update([{k: torch.from_numpy(v) for k, v in p.items()} for p in g], ts, tp, 1e-2)
    assert ts["t"] == int(js["t"]) == 3
    for a, b in zip(tp, jp):
        for k in b:
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), atol=1e-6)
    clipped, norm = topt.clip_by_global_norm(tp, 0.5)
    jclipped, jnorm = jopt.clip_by_global_norm(jp, 0.5)
    assert float(norm) == pytest.approx(float(jnorm), rel=1e-6)
    np.testing.assert_allclose(clipped[0]["w"].numpy(), np.asarray(jclipped[0]["w"]), atol=1e-6)
    with pytest.raises(NotImplementedError, match="A.18"):
        topt.make_optimizer("adafactor")


def test_driver_counts_restarts_and_refuses_checkpoints():
    arch = make_yolo_tiled_arch((32, 32), 2, 2, 2, backend="cuda", device="cpu")
    init_state, step = make_train_step(arch, ParallelConfig(), TrainConfig(optimizer="sgd", steps=3))
    batch = {"x": torch.from_numpy(_batch(0, b=2)["x"]), "t": torch.zeros(arch.target_shape(2))}
    failed = []

    def fault(s):
        if s == 1 and not failed:
            failed.append(s)
            raise RuntimeError("injected")

    report = run_training(init_state=init_state, train_step=step, make_batch=lambda s: batch,
                          steps=3, cfg=DriverConfig(), fault_hook=fault)
    # the retry starts the run over: the counts cover the last attempt only
    assert report.restarts == 1 and report.steps_done == 3 and len(report.step_times) == 3
    assert np.isfinite(report.last_metrics["loss"])
    clean = run_training(init_state=init_state, train_step=step, make_batch=lambda s: batch,
                         steps=2, cfg=DriverConfig())
    assert clean.restarts == 0 and clean.steps_done == 2
    with pytest.raises(NotImplementedError, match="A.15"):
        run_training(init_state=init_state, train_step=step, make_batch=lambda s: batch,
                     steps=1, cfg=DriverConfig(ckpt_dir="ckpt"))
    with pytest.raises(RuntimeError, match="injected"):
        run_training(init_state=init_state, train_step=step, make_batch=lambda s: batch,
                     steps=2, cfg=DriverConfig(max_restarts=0),
                     fault_hook=lambda s: (_ for _ in ()).throw(RuntimeError("injected")))


def test_arch_training_surface():
    arch = make_yolo_tiled_arch((32, 32), 4, 2, 2, backend="cuda", device="cpu")
    assert arch.kind == "tiled_cnn" and arch.loss_local is l2_loss_local
    assert arch.target_shape(3) == (3, 8, 8, 64)
    params = arch.init(0)
    assert params[0]["w"].device.type == "cpu" and "bn_scale" in params[0]
    init_state, _ = make_train_step(arch, ParallelConfig(), TrainConfig(grad_compression="int8"))
    st = init_state(0)
    assert isinstance(st, TrainState) and st.step == 0 and st.ef is not None
    assert set(st.opt) == {"m", "v", "t"}
    with pytest.raises(NotImplementedError, match="A.18"):
        make_train_step(object(), ParallelConfig(), TrainConfig())


def test_on_grads_sees_the_steps_own_gradients():
    """The trainer's gradient observer gets, at every step, the batch-end
    gradients its update then uses: step 0's equal the deferred step's on
    the same params and batch."""
    arch = make_yolo_tiled_arch((32, 32), 4, 2, 2, [Group(0, 1), Group(2, 3)], device="cpu")
    seen = []
    init_state, step = make_train_step(
        arch, ParallelConfig(grad_accum=2), TrainConfig(optimizer="sgd", warmup=0, steps=2),
        on_grads=lambda s, loss, grads: seen.append((s, float(loss), grads)))
    state = init_state(0)
    b = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    loss, grads = tfu.make_deferred_grad_step(arch.plan, arch.mesh, l2_loss_local, microbatches=2)(
        state.params, b["x"].reshape(2, 2, *HW, 3), b["t"].reshape(2, 2, 8, 8, 64))
    state, m = step(state, b)
    state, _ = step(state, b)
    assert [s for s, *_ in seen] == [0, 1] and seen[0][1] == float(m["loss"]) == float(loss)
    assert all(torch.equal(a[k], g[k]) for a, g in zip(seen[0][2], grads) for k in g)


def test_trainer_keeps_float64_params_in_float64():
    """An fp64 run (the exact reference a card run is held against) keeps
    fp64 through the loss, the clipping and the SGD and AdamW updates; the
    fp32 run's arithmetic is the reference's fp32."""
    arch = make_yolo_tiled_arch((32, 32), 4, 2, 2, backend="torch", device="cpu")
    b = {k: torch.from_numpy(v).double() for k, v in _batch(0).items()}
    for opt in ("sgd", "adamw"):
        init_state, step = make_train_step(arch, ParallelConfig(grad_accum=2),
                                           TrainConfig(optimizer=opt, warmup=0, steps=2))
        st32 = init_state(0)
        assert all(v.dtype == torch.float32 for v in topt.tree_leaves(st32.opt["m"]))
        p64 = topt.tree_map(torch.Tensor.double, st32.params)
        st = TrainState(p64, topt.make_optimizer(opt).init(p64), 0)
        st, m = step(st, b)
        assert m["loss"].dtype == m["grad_norm"].dtype == torch.float64
        assert all(v.dtype == torch.float64 for v in topt.tree_leaves([st.params, st.opt["m"]]))
        st32, m32 = step(st32, {k: v.float() for k, v in b.items()})
        assert float(m32["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
        if opt == "sgd":    # AdamW's first step is sign(g)-like: see ADAM_WELL_CONDITIONED
            want = [{k: v.numpy() for k, v in p.items()} for p in st.params]
            assert _max_param_err(st32, want) < PARAM_ATOL
    s, c = l2_loss_local(torch.ones(2, dtype=torch.float64), torch.zeros(2, dtype=torch.float64))
    assert s.dtype == torch.float64 and c == 2.0
    assert l2_loss_local(torch.ones(2, dtype=torch.bfloat16), torch.zeros(2))[0].dtype == torch.float32


def test_yolo_train_fns_agree_with_the_untiled_reference():
    from repro_torch.models.yolo import init_yolo, make_yolo_train_fns

    arch = make_yolo_tiled_arch((32, 32), 4, 2, 2, [Group(0, 1), Group(2, 3)], device="cpu")
    params = init_yolo(0, arch.plan)
    assert all(torch.equal(a[k], b[k]) for a, b in zip(params, arch.init(0)) for k in a)
    b = _batch(0)
    x, t = torch.from_numpy(b["x"]), torch.from_numpy(b["t"])
    fwd, loss, step = make_yolo_train_fns(arch.plan, arch.mesh, microbatches=2)
    np.testing.assert_allclose(fwd(params, x).numpy(),
                               tfu.reference_forward(params, x, arch.plan).numpy(), atol=1e-5)
    ref = tfu.reference_loss(params, x, t, arch.plan, l2_loss_local)
    assert abs(float(loss(params, x, t)) - float(ref)) < LOSS_RTOL * max(1.0, float(ref))
    mean, grads = step(params, x.reshape(2, 2, *x.shape[1:]), t.reshape(2, 2, *t.shape[1:]))
    assert np.isfinite(float(mean)) and [set(g) for g in grads] == [set(p) for p in params]


def test_launcher_trains_on_cpu(capsys):
    from repro_torch.launch.train import main

    assert main(["--arch", "yolov2-tiled", "--device", "cpu", "--input-hw", "32",
                 "--depth", "4", "--steps", "2", "--grid", "2", "--batch", "4",
                 "--grad-accum", "2", "--optimizer", "sgd", "--compress", "int8",
                 "--groups", "2"]) == 0
    out = capsys.readouterr().out
    assert "done: steps=2 restarts=0" in out and "groups=[(0, 1, 'spatial'), (2, 3, 'spatial')]" in out


@pytest.mark.parametrize("flags,item", [
    (["--groups", "auto"], "A.9"),
    (["--cluster", "pi3x3+jetson"], "A.9"),
    (["--schedule", "overlap"], "A.10"),
    (["--crossover", "2"], "A.11"),
    (["--pipeline", "2"], "A.13"),
    (["--wire-codec", "int8"], "A.14"),
    (["--ckpt-dir", "ckpt"], "A.15"),
    (["--fault-schedule", "drop:1@2"], "A.15"),
    (["--arch", "stablelm-1.6b"], "A.18"),
    (["--optimizer", "adafactor"], "A.18"),
])
def test_launcher_unported_flags_name_their_roadmap_item(flags, item):
    from repro_torch.launch.train import main

    base = ["--device", "cpu", "--input-hw", "32", "--depth", "4", "--steps", "1", "--grid", "2"]
    with pytest.raises(NotImplementedError, match=item):
        main(base + flags)


def test_launcher_defaults_to_the_card():
    from repro_torch.launch.train import main

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--input-hw", "32", "--depth", "4", "--steps", "1"])
