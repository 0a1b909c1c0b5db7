"""The padded ragged cluster plan over a 3-step training trajectory
(ROADMAP C.5): is a params miss after 3 steps an executor fault or fp32
rounding?

The plan is ``chip_smoke.py``'s phase-14 cluster - ``pi3x3+jetson`` on the
2x2 grid with ``groups="auto"``, its FLOPs-balanced partition - at 64x64
and depth 8 (the cluster case of ``tests/test_torch_ragged.py``), trained
as phase 14 trains it: batch 8 in 2 microbatches, Darknet's SGD at lr 1e-3,
no warmup, BN on, 3 trainer steps from the same params and batches.

- fp64: the padded and spec executors against each other and against the
  untiled (1x1) trainer, to ``FP64_ATOL``.  Equal, so the executors carry
  the trajectory exactly and any fp32 miss is rounding.
- fp32: each BN-bias leaf's update, normwise from the fp64 trainer's, for
  the port's padded plan beside the JAX reference's padded plan trained
  the same way (4 fake devices in a subprocess), and beside the port's
  untiled fp32 trainer.  Other summation orders of the same fp32 sums land
  far apart on these leaves (a max-pool window whose top two values sit
  within fp32's rounding sends its gradient elsewhere), so the port is held
  to ``chip_smoke.py``'s params bar against the largest of those samples:
  max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR x the sample).
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import spatial as jsp
from repro.models.yolo import yolov2_16_layers as jax_yolo_layers
from repro_torch.configs.base import ParallelConfig, TrainConfig
from repro_torch.interop import params_from_jax
from repro_torch.launch.train import make_batch_fn
from repro_torch.models.yolo import make_yolo_tiled_arch
from repro_torch.optim.optimizers import make_optimizer, tree_leaves, tree_map
from repro_torch.train.trainer import TrainState, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, DEPTH, GRID = 64, 8, 2
BATCH, MICRO, STEPS, LR = 8, 2, 3, 1e-3
CLUSTER = dict(groups="auto", hw="pi3x3+jetson", batch=BATCH, microbatches=MICRO)
FP64_ATOL = 1e-12
# chip_smoke.py: WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR
WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR = 1e-3, 2.0


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _np_params():
    params = jsp.init_stack_params(jax.random.PRNGKey(0), jax_yolo_layers()[:DEPTH])
    return [{k: np.asarray(v) for k, v in p.items()} for p in params]


def _arch(ragged_exec=None, backend="cuda"):
    if ragged_exec is None:      # the untiled trainer: one tile
        return make_yolo_tiled_arch(input_hw=(HW, HW), depth=DEPTH, n=1, m=1, backend=backend,
                                    device="cpu")
    return make_yolo_tiled_arch(input_hw=(HW, HW), depth=DEPTH, n=GRID, m=GRID, backend=backend,
                                ragged_exec=ragged_exec, device="cpu", **CLUSTER)


def _batches(arch):
    make_batch = make_batch_fn(BATCH, HW, arch.target_shape(BATCH), 0, "cpu")
    return [{k: v.numpy() for k, v in make_batch(s).items()} for s in range(STEPS)]


def _train(arch, params, batches, dtype):
    """The port's trainer for STEPS steps from ``params``; the final params
    as a flat list."""
    _, step = make_train_step(arch, ParallelConfig(grad_accum=MICRO),
                              TrainConfig(lr=LR, optimizer="sgd", warmup=0, steps=STEPS, seed=0))
    p = tree_map(lambda t: t.to(dtype), params_from_jax(params, "cpu"))
    state = TrainState(p, make_optimizer("sgd").init(p), 0)
    for b in batches:
        state, _ = step(state, {k: torch.from_numpy(v).to(dtype) for k, v in b.items()})
    return tree_leaves(state.params)


_JAX_TRAIN = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from repro.configs.base import ParallelConfig, TrainConfig
    from repro.core.fusion import build_stack_plan
    from repro.launch.mesh import make_tile_mesh
    from repro.models.tiled_cnn import TiledCNNArch
    from repro.models.yolo import l2_loss_local, yolov2_16_layers
    from repro.optim.optimizers import make_optimizer
    from repro.train.trainer import TrainState, make_train_step
    HW, DEPTH, GRID, MICRO, STEPS, LR, CLUSTER = %r
    d = dict(np.load(sys.argv[1]))
    layers = yolov2_16_layers()[:DEPTH]
    params = [{k: d[f"p{i}_{k}"] for k in ("w", "b", "bn_scale", "bn_bias") if f"p{i}_{k}" in d}
              for i in range(DEPTH)]
    groups = CLUSTER.pop("groups")
    plan = build_stack_plan((HW, HW), layers, GRID, GRID, groups, ragged_exec="padded", **CLUSTER)
    assert not plan.is_uniform
    arch = TiledCNNArch(plan=plan, mesh=make_tile_mesh(GRID, GRID), loss_local=l2_loss_local)
    _, step = make_train_step(arch, ParallelConfig(grad_accum=MICRO),
                              TrainConfig(lr=LR, optimizer="sgd", warmup=0, steps=STEPS))
    state = TrainState(params, make_optimizer("sgd").init(params), np.int32(0))
    step = jax.jit(step)
    for s in range(STEPS):
        state, _ = step(state, {"x": d[f"x{s}"], "t": d[f"t{s}"]})
    np.savez(sys.argv[2], **{f"p{i}_{k}": np.asarray(v) for i, p in enumerate(state.params)
                             for k, v in p.items()})
""")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Params, batches, the fp64 untiled trainer's final params and the
    JAX reference's fp32 padded plan's final params."""
    params = _np_params()
    batches = _batches(_arch(None))
    tmp = tmp_path_factory.mktemp("trajectory")
    inputs = {f"p{i}_{k}": v for i, p in enumerate(params) for k, v in p.items()}
    for s, b in enumerate(batches):
        inputs[f"x{s}"], inputs[f"t{s}"] = b["x"], b["t"]
    np.savez(tmp / "in.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    args = (HW, DEPTH, GRID, MICRO, STEPS, LR, dict(CLUSTER))
    subprocess.run([sys.executable, "-c", _JAX_TRAIN % (args,), tmp / "in.npz", tmp / "out.npz"],
                   env=env, check=True, timeout=600)
    out = np.load(tmp / "out.npz")
    jax_final = [out[f"p{i}_{k}"] for i, p in enumerate(params) for k in p]
    names = [f"{i}.{k}" for i, p in enumerate(params) for k in p]
    ref64 = _train(_arch(None, backend="torch"), params, batches, torch.float64)
    return dict(params=params, batches=batches, names=names, ref64=ref64, jax32=jax_final)


def test_the_plan_is_the_padded_cluster():
    plan = _arch("padded").plan
    assert not plan.is_uniform and plan.ragged_exec == "padded"
    assert plan.tile_rows[0] == (8, 56) and plan.tile_cols[0] == (8, 56)


@pytest.mark.parametrize("ragged_exec", ["padded", "spec"])
def test_fp64_trajectory_equals_the_untiled_trainer(case, ragged_exec):
    """In fp64 the 3-step trajectory of each executor is the untiled
    trainer's to rounding: no executor fault moves the params."""
    got = _train(_arch(ragged_exec), case["params"], case["batches"], torch.float64)
    for n, a, b in zip(case["names"], got, case["ref64"]):
        assert float((a - b).abs().max()) < FP64_ATOL, n


def test_fp64_padded_and_spec_trajectories_agree(case):
    pad = _train(_arch("padded"), case["params"], case["batches"], torch.float64)
    spec = _train(_arch("spec"), case["params"], case["batches"], torch.float64)
    for n, a, b in zip(case["names"], pad, spec):
        assert float((a - b).abs().max()) < FP64_ATOL, n


def _update_errs(final, case):
    """Per leaf: normwise distance of (final - initial) from the fp64
    untiled trainer's update."""
    p0 = [torch.from_numpy(v).double() for p in case["params"] for v in p.values()]
    out = []
    for f, r, p in zip(final, case["ref64"], p0):
        u = r - p
        out.append(float(((torch.as_tensor(f).double() - p) - u).abs().max() / u.abs().max()))
    return out


def test_fp32_bn_bias_updates_sit_where_the_references_do(case):
    """The port's padded plan in fp32, BN-bias leaf by leaf, against the
    fp64 trainer - beside the JAX reference's padded plan and the port's
    untiled trainer in fp32.  The port must meet phase 14's params bar
    taken from the largest of those fp32 samples."""
    port = _update_errs(_train(_arch("padded"), case["params"], case["batches"], torch.float32),
                        case)
    jax32 = _update_errs(case["jax32"], case)
    untiled = _update_errs(_train(_arch(None), case["params"], case["batches"], torch.float32),
                           case)
    rows = [(n, a, b, c) for n, a, b, c in zip(case["names"], port, jax32, untiled)
            if n.endswith("bn_bias")]
    assert len(rows) == sum(not l.pool for l in _arch(None).plan.layers)
    for n, a, b, c in rows:
        bar = max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * max(b, c))
        assert a <= bar, (n, a, b, c)
    # every leaf, not just the BN biases, within the same rule
    for n, a, b, c in zip(case["names"], port, jax32, untiled):
        assert a <= max(WGRAD_NORM_TOL, GRAD_FLOOR_FACTOR * max(b, c)), (n, a, b, c)
