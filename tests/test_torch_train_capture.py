"""What the captured training step (ROADMAP A item 1) depends on, on the CPU.

A CUDA graph runs only on the card, so these tests hold its parts:

- the LR schedule and the optimizers' step counters as device tensors: the
  schedule of a 0-d int32 step, and AdamW's bias corrections, within 1 fp32
  ulp of the reference's at every step 0 .. total + 2 (``_held``: 1 ulp of
  the fp64 value the port rounds once, and of the reference's fp32 value
  beyond the reference's own rounding); each optimizer's
  count a 0-d int32 tensor equal to the reference's, its updates within
  ``tests/test_torch_train.py``'s 1e-6;
- the eager body that the graph records, over 5 steps with warmup 3 (the LR
  changes at every step but at the warmup's end, which it crosses), against the jitted
  reference trainer: the reduced tiled CNN on 2x2 (SGD, int8 error feedback;
  against the untiled 1x1 reference, ``INT8_PARAM_TOL``), a reduced Qwen2
  (AdamW) and a reduced Jamba (adafactor, MoE), with the bars of
  ``tests/test_torch_lm.py``;
- ``capture_train_step`` refuses the CPU, and the launchers run the eager
  step there;
- ``StateBinder``, the captured step's static state: adopted tensors are
  not copied, a restored state is copied in, another shape, dtype or
  structure raises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_v0_1_52b as jjamba
from repro.configs import qwen2_7b as jqwen
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.core import fusion as jfu
from repro.core.tiling import Group as JGroup
from repro.data import synthetic as jsyn
from repro.launch.mesh import make_tile_mesh as jax_mesh
from repro.models import registry as jreg
from repro.models.tiled_cnn import TiledCNNArch as JArch
from repro.models.yolo import l2_loss_local as jax_l2
from repro.models.yolo import yolov2_16_layers as jax_yolo_layers
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro.train import trainer as jtrain
from repro_torch.configs import jamba_v0_1_52b as tjamba
from repro_torch.configs import qwen2_7b as tqwen
from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.core import fusion as tfu
from repro_torch.core.tiling import Group
from repro_torch.data import synthetic as tsyn
from repro_torch.interop import lm_params_from_jax, params_from_jax
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_tile_mesh
from repro_torch.models import registry as treg
from repro_torch.models.tiled_cnn import TiledCNNArch
from repro_torch.models.yolo import l2_loss_local
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsched
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train.trainer import (
    StateBinder,
    TrainState,
    capture_train_step,
    make_train_step,
)

WARMUP, STEPS, LR = 3, 5, 1e-3       # the LR changes at every step, across the warmup's end
PARAM_ATOL = 1e-5                    # tests/test_torch_train.py, tests/test_torch_lm.py
INT8_PARAM_TOL = 1e-5                # tests/test_torch_train.py (see there)
UPDATE_ATOL = 1e-6                   # tests/test_torch_train.py::test_optimizer_updates_match_jax
ADAM_WELL_CONDITIONED = 1e-6         # tests/test_torch_lm.py
ADAM_ILL_SHARE = 5e-3
HW = (32, 32)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _sorted_leaves(tree) -> list:
    """Leaves with dict keys in sorted order, as ``jax.tree.leaves``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _sorted_leaves(v)]
    return [tree]


def _held(got: torch.Tensor, ref, exact: float) -> bool:
    """The bar of a device schedule value: ``got`` (a 0-d tensor) rounded to
    fp32 lies within 1 fp32 ulp of ``exact`` (the fp64 evaluation, which the
    port rounds once), and within 1 ulp of the reference's fp32 ``ref`` plus
    the reference's own distance from ``exact`` (its fp32 operations round
    one by one: up to ~3.5 ulps near the cosine's tail, measured at total
    1000)."""
    g, r = np.float32(got.item()), np.float32(ref)
    ulp = np.spacing(r)
    return (got.shape == () and abs(float(g) - exact) <= np.spacing(g)
            and abs(float(g) - float(r)) <= ulp + abs(float(r) - exact))


# ---------------------------------------------------------------------------
# (a) the schedule and the counters as device tensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(WARMUP, STEPS), (10, 100), (0, 4), (100, 1000)])
def test_device_schedule_is_the_references_within_one_ulp(warmup, total):
    """Steps 0 .. total + 2 of a 0-d int32 step: 1 fp32 ulp (``_held``), and
    the host-int path's value, rounded to fp32, bit for bit."""
    for s in range(total + 3):
        got = tsched.cosine_schedule(torch.tensor(s, dtype=torch.int32), warmup, total, 3e-4)
        exact = tsched.cosine_schedule(s, warmup, total, 3e-4)
        want = jsched.cosine_schedule(jnp.int32(s), warmup, total, 3e-4)
        assert _held(got, want, exact), (s, got.item(), float(want), exact)
        assert np.float32(got.item()) == np.float32(exact)


def test_adamw_bias_corrections_are_the_references_within_one_ulp():
    for t in range(1, STEPS + 3):
        bc1, bc2 = topt.bias_corrections(torch.tensor(t, dtype=torch.int32), 0.9, 0.95)
        tj = jnp.int32(t).astype(jnp.float32)
        assert _held(bc1, 1 - 0.9 ** tj, 1 - 0.9 ** t), t
        assert _held(bc2, 1 - 0.95 ** tj, 1 - 0.95 ** t), t


@pytest.mark.parametrize("name", ["adamw", "sgd", "adafactor"])
def test_step_counters_are_int32_device_tensors_equal_to_the_references(name):
    rng = np.random.default_rng(6)
    params = [{"w": rng.standard_normal((3, 4)).astype(np.float32)},
              {"w": rng.standard_normal(5).astype(np.float32)}]
    jo = jopt.make_optimizer(name, weight_decay=0.1)
    to = topt.make_optimizer(name, weight_decay=0.1)
    jp, js = params, jo.init(params)
    tp = [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]
    ts = to.init(tp)
    assert isinstance(ts["t"], torch.Tensor) and ts["t"].shape == () \
        and ts["t"].dtype == torch.int32 and int(ts["t"]) == int(js["t"]) == 0
    for s in range(STEPS + 3):
        g = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p.items()}
             for p in params]
        lr_t = tsched.cosine_schedule(torch.tensor(s, dtype=torch.int32), WARMUP, STEPS, LR)
        lr_j = jsched.cosine_schedule(jnp.int32(s), WARMUP, STEPS, LR)
        jp, js = jo.update(g, js, jp, lr_j)
        tp, ts = to.update([{k: torch.from_numpy(v) for k, v in p.items()} for p in g], ts, tp,
                           lr_t)
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == int(js["t"]) == s + 1
        for a, b in zip(tp, jp):
            for k in b:
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]), atol=UPDATE_ATOL)


# ---------------------------------------------------------------------------
# (b) the eager body over steps whose LR differs, against the jitted reference
# ---------------------------------------------------------------------------

CNN_LAYERS = jax_yolo_layers()[:4]
CNN_GROUPS = [(0, 1), (2, 3)]


def _cnn_batch(step, b=4):
    """The launcher's make_batch recipe at 32x32, depth 4 (target 8x8x64)."""
    r = np.random.default_rng([0, step])
    return {"x": r.standard_normal((b, *HW, 3), np.float32),
            "t": 0.05 * r.standard_normal((b, 8, 8, 64), np.float32)}


def test_cnn_body_with_warmup_matches_the_jitted_reference_int8():
    """2x2 tiles, depth 4, 32x32, SGD, int8 error feedback: the port's eager
    body against the reference's jitted untiled trainer."""
    jplan = jfu.build_stack_plan(HW, CNN_LAYERS, 1, 1, [JGroup(s, e) for s, e in CNN_GROUPS])
    jarch = JArch(plan=jplan, mesh=jax_mesh(1, 1), loss_local=jax_l2)
    tcfg = dict(lr=LR, optimizer="sgd", warmup=WARMUP, steps=STEPS, grad_compression="int8")
    init_j, step_j = jtrain.make_train_step(jarch, JParallel(grad_accum=2), JTrain(**tcfg))
    js = init_j(jax.random.PRNGKey(0))
    params0 = [{k: np.asarray(v) for k, v in p.items()} for p in js.params]
    step_j = jax.jit(step_j)
    jlrs = []
    for s in range(STEPS):
        js, m = step_j(js, _cnn_batch(s))
        jlrs.append(float(m["lr"]))

    from repro_torch.models.yolo import yolov2_16_layers

    plan = tfu.build_stack_plan(HW, yolov2_16_layers()[:4], 2, 2,
                                [Group(s, e) for s, e in CNN_GROUPS])
    arch = TiledCNNArch(plan=plan, mesh=make_tile_mesh(2, 2, "cpu"), loss_local=l2_loss_local)
    init_t, step_t = make_train_step(arch, ParallelConfig(grad_accum=2), TrainConfig(**tcfg))
    ts = init_t(0)._replace(params=params_from_jax(params0, "cpu"))
    lrs = []
    for s in range(STEPS):
        ts, m = step_t(ts, {k: torch.from_numpy(v) for k, v in _cnn_batch(s).items()})
        lrs.append(m["lr"])
    # every step its own LR but steps 2 and 3: the warmup's last and the
    # cosine's first both take the peak
    assert len(set(jlrs)) == STEPS - 1
    assert all(_held(a, b, tsched.cosine_schedule(i, WARMUP, STEPS, LR))
               for i, (a, b) in enumerate(zip(lrs, jlrs))), (lrs, jlrs)
    assert ts.step.dtype == torch.int32 and int(ts.step) == STEPS and ts.ef is not None
    assert int(ts.opt["t"]) == int(js.opt["t"]) == STEPS
    err = max(float(np.max(np.abs(p[k].numpy() - np.asarray(w[k]))))
              for p, w in zip(ts.params, js.params) for k in w)
    assert err < INT8_PARAM_TOL, err


LM_CASES = {
    # name: (reference config module, port config module, optimizer, grad_accum)
    "qwen2-7b": (jqwen, tqwen, "adamw", 2),
    "jamba-v0.1-52b": (jjamba, tjamba, "adafactor", 1),
}


@pytest.mark.parametrize("name", sorted(LM_CASES))
def test_lm_body_with_warmup_matches_the_jitted_reference(name):
    """A reduced Qwen2 (AdamW) and a reduced Jamba (adafactor, MoE): losses
    within 1e-5, params within PARAM_ATOL but for elements whose
    second-moment root sits at rounding level, which are held to
    tests/test_torch_lm.py's step bound, and of which at most 0.5 % miss
    PARAM_ATOL (tests/test_torch_moe_configs.py's rule: an expert sees few
    tokens, so many of its gradients sit at rounding level)."""
    jmod, tmod, optimizer, accum = LM_CASES[name]
    jcfg, tcfg = jmod.reduced(), tmod.reduced()
    train = dict(lr=LR, warmup=WARMUP, steps=STEPS, optimizer=optimizer)
    bundle = jreg.bundle_from_cfg(jcfg)
    init_j, step_j = jtrain.make_train_step(bundle, JParallel(grad_accum=accum, remat="full"),
                                            JTrain(**train))
    js = init_j(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, js.params)
    specs = bundle.input_specs(JShape("t", 16, 4, "train"))
    step_j = jax.jit(step_j)
    jlosses, jlrs = [], []
    for s in range(STEPS):
        js, m = step_j(js, jsyn.synth_batch(specs, jcfg, 0, s))
        jlosses.append(float(m["loss"]))
        jlrs.append(float(m["lr"]))

    arch = treg.bundle_from_cfg(tcfg, "cpu")
    init_t, step_t = make_train_step(arch, ParallelConfig(grad_accum=accum, remat="full"),
                                     TrainConfig(**train))
    ts = init_t(0)._replace(params=lm_params_from_jax(params0, "cpu"))
    tspecs = arch.input_specs(ShapeConfig("t", 16, 4, "train"))
    losses, vs = [], []
    for s in range(STEPS):
        ts, m = step_t(ts, tsyn.place(tsyn.synth_batch(tspecs, tcfg, 0, s), "cpu"))
        losses.append(float(m["loss"]))
        assert _held(m["lr"], jlrs[s], tsched.cosine_schedule(s, WARMUP, STEPS, LR)), s
        vs.append([v.clone() for v in _sorted_leaves(ts.opt["v"])])    # updated in place
    assert len(set(jlrs)) == STEPS - 1
    assert int(ts.step) == int(js.step) == STEPS and int(ts.opt["t"]) == int(js.opt["t"])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = _sorted_leaves(ts.params)
    want = [np.asarray(x) for x in jax.tree.leaves(js.params)]
    assert len(got) == len(want)
    decay = 0.95 if optimizer == "adamw" else 0.99
    n_ill = n_all = 0
    for i, (p, w) in enumerate(zip(got, want)):
        ill = np.zeros(w.shape, bool)
        for t, v in enumerate(vs, start=1):
            root = np.sqrt(v[i].numpy() / (1 - decay ** t)).reshape(-1)
            if root.size == w.size:
                ill |= ((root > 0) & (root < ADAM_WELL_CONDITIONED)).reshape(w.shape)
        d = np.abs(p.numpy() - w)
        assert np.all(d[~ill] < PARAM_ATOL), (i, float(d[~ill].max()))
        assert np.all(d[ill] <= 2 * STEPS * LR * (1 + 0.1 * np.abs(w[ill]))), i
        n_ill += int((ill & (d >= PARAM_ATOL)).sum())
        n_all += ill.size
    assert n_ill <= ADAM_ILL_SHARE * n_all, (n_ill, n_all)


# ---------------------------------------------------------------------------
# (c) the CPU refuses a capture; the launchers run the eager step there
# ---------------------------------------------------------------------------


def test_capture_train_step_refuses_the_cpu():
    arch = treg.get_arch("qwen2-7b", reduced=True, device="cpu")
    _, step = make_train_step(arch, ParallelConfig(), TrainConfig())
    with pytest.raises(ValueError, match="needs a CUDA device"):
        capture_train_step(step, "cpu")
    assert tlaunch.jit_step(step, "cpu") is step
    _, observed = make_train_step(arch, ParallelConfig(), TrainConfig(),
                                  on_grads=lambda *a: None)
    with pytest.raises(ValueError, match="on_grads observer runs eagerly"):
        capture_train_step(observed, "cuda")


@pytest.mark.parametrize("argv", [
    ["--arch", "yolov2-tiled", "--input-hw", "32", "--depth", "4", "--steps", "3"],
    ["--arch", "qwen2-7b", "--steps", "3", "--batch", "2", "--seq", "16"],
])
def test_launchers_run_the_eager_step_on_the_cpu(argv, capsys):
    assert tlaunch.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "done: steps=3 restarts=0" in out and "step: eager on cpu" in out
    assert "CUDA graphs" not in out


# ---------------------------------------------------------------------------
# (d) the static state
# ---------------------------------------------------------------------------


def _state(seed=0, step=2):
    g = torch.Generator().manual_seed(seed)
    p = [{"w": torch.randn((3, 4), generator=g)}, {"b": torch.randn(5, generator=g)}]
    opt = {"m": [{"w": torch.zeros(3, 4)}, {"b": torch.zeros(5)}],
           "t": torch.tensor(step, dtype=torch.int32)}
    return TrainState(p, opt, torch.tensor(step, dtype=torch.int32), None)


def test_state_binder_adopts_without_copying_and_copies_a_restore_in():
    st = _state()
    binder = StateBinder(st, "cpu")
    assert binder.state.params[0]["w"] is st.params[0]["w"]
    assert binder.state.step is st.step and binder.state.opt["t"] is st.opt["t"]
    assert binder.bind(st) is False and binder.copies == 0          # its own tensors
    assert binder.bind(binder.state) is False
    restored = _state(seed=1, step=7)                                 # a checkpoint's
    static = [binder.state.params[0]["w"], binder.state.step]
    assert binder.bind(restored) is True and binder.copies == 1
    assert binder.state.params[0]["w"] is static[0] and binder.state.step is static[1]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(list(binder.state[:3])),
                                                 tree_leaves(list(restored[:3]))))
    assert int(binder.state.step) == 7 and binder.state.params[0]["w"] is not restored.params[0]["w"]


def test_state_binder_takes_host_ints_as_int32_counters():
    st = _state()._replace(step=4)
    binder = StateBinder(st, "cpu")
    assert binder.state.step.dtype == torch.int32 and int(binder.state.step) == 4
    assert binder.bind(_state(step=9)._replace(step=9)) is True
    assert int(binder.state.step) == 9


@pytest.mark.parametrize("bad", ["shape", "dtype", "structure"])
def test_state_binder_refuses_another_leaf_or_structure(bad):
    binder = StateBinder(_state(), "cpu")
    other = _state(seed=3)
    if bad == "shape":
        other.params[0]["w"] = torch.zeros((4, 3))
        match = r"state leaf 0: torch.float32 \(4, 3\), captured with torch.float32 \(3, 4\)"
    elif bad == "dtype":
        other.params[1]["b"] = other.params[1]["b"].double()
        match = "torch.float64"
    else:
        other = other._replace(ef=[{"w": torch.zeros(3, 4)}])
        match = "structure"
    with pytest.raises(ValueError, match=match):
        binder.bind(other)
