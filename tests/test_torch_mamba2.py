"""The port's Mamba2 path (reduced Mamba2-780m, fp32) against the JAX package.

Params are initialised by JAX and handed over with ``lm_params_from_jax``;
inputs are drawn with numpy.  On the CPU the SSD op (B5) and RMSNorm (B6)
take their plain versions.
- ``seq_halo_conv1d`` against JAX's, and its causality
  (``tests/test_lm_math.py:102``);
- the SSD scan's chunk invariance and the naive per-step recurrence
  (``tests/test_lm_math.py:131,149``), run on the port;
- ``mamba_block`` (its param gradients normwise within 1e-4), ``apply_lm``,
  ``lm_loss`` and its gradients, remat ``none`` and ``full``, within 1e-5
  (``tests/test_torch_lm.py``'s bar);
- 3 steps of the LM ``make_train_step`` against JAX's, step from step,
  with ``tests/test_torch_lm.py``'s bar and AdamW caveat;
- the launcher's Mamba2 mode on the CPU; the decode step and the
  sequence-sharded block and forward run.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_780m as jcfg_mod
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.core.sequence import seq_halo_conv1d as jax_conv1d
from repro.data import synthetic as jsyn
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba
from repro.models import registry as jreg
from repro.train import trainer as jtrain
from repro_torch.configs import mamba2_780m as tcfg_mod
from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.core.sequence import seq_halo_conv1d
from repro_torch.data import synthetic as tsyn
from repro_torch.interop import lm_params_from_jax
from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.kernels.ssd_chunk.kernel import ssd_chunk_fwd
from repro_torch.launch.mesh import make_virtual_mesh
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import registry as treg
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.parallel.api import sharding_ctx
from repro_torch.train.trainer import lm_value_and_grad, make_train_step

ATOL = 1e-5          # tests/test_torch_lm.py: apply_lm, loss and every grad leaf
PARAM_ATOL = 1e-5    # params after 3 trainer steps
NORM_RTOL = 1e-4     # normwise: max |err| <= NORM_RTOL x max |want| (the fp32 rtol)
ADAM_WELL_CONDITIONED = 1e-6     # tests/test_torch_lm.py's AdamW caveat
ADAM_ILL_SHARE = 5e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jcfg_mod.reduced()
TCFG = tcfg_mod.reduced()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the same as numpy) of the reduced config."""
    p = jlm.init_lm(jax.random.PRNGKey(0), JCFG)
    return p, jax.tree.map(np.asarray, p)


def _named(tree, prefix=""):
    """(path, leaf) pairs of a dict/list tree in sorted-key order (JAX's)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _batch(b=2, t=64, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, JCFG.vocab, (b, t), dtype=np.int32)
    labels = rng.integers(0, JCFG.vocab, (b, t), dtype=np.int32)
    labels[0, :3] = -100
    return {"tokens": tokens, "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# core/sequence.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,k,bias", [((2, 16, 8), 4, True), ((1, 5, 12), 4, False),
                                          ((3, 9, 6), 2, True)])
def test_seq_halo_conv1d_matches_jax(shape, k, bias):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, np.float32)
    w = rng.standard_normal((k, shape[-1]), np.float32)
    b = rng.standard_normal(shape[-1:], np.float32) if bias else None
    want = jax_conv1d(jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b), None)
    got = seq_halo_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                          None if b is None else torch.from_numpy(b), None)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_seq_halo_conv1d_unsharded_is_causal():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 16, 8), np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 8), np.float32))
    b = torch.zeros(8)
    y = seq_halo_conv1d(x, w, b, axis=None)
    x2 = x.clone()
    x2[:, 10:] = 99.0
    y2 = seq_halo_conv1d(x2, w, b, axis=None)
    torch.testing.assert_close(y[:, :10], y2[:, :10], rtol=1e-5, atol=0)
    assert not torch.allclose(y[:, 10:], y2[:, 10:])
    # sharded over 4 shards of the "seq" axis (A.18.8), each shard's halo
    # from the one before: the unsharded conv, causal as it
    with sharding_ctx(make_virtual_mesh({"seq": 4}, "cpu")):
        ys = seq_halo_conv1d(x.view(2, 4, 4, 8), w, b, "seq", seq_dim=2, shard_dim=1)
    torch.testing.assert_close(ys.reshape(2, 16, 8), y, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# SSD properties (tests/test_lm_math.py), on the port
# ---------------------------------------------------------------------------


def _ssd_inputs(b, t, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p), np.float32)
    dt = np.logaddexp(rng.standard_normal((b, t, h)), 0.0).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(h)).astype(np.float32)
    Bm = rng.standard_normal((b, t, g, n), np.float32)
    Cm = rng.standard_normal((b, t, g, n), np.float32)
    return [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]


@pytest.mark.parametrize("scan", ["op", "plain"])
def test_ssd_chunk_invariance(scan):
    """Result independent of chunk size (state-space duality)."""
    args = _ssd_inputs(1, 64, 4, 8, 2, 8)
    fn = (lambda c: tmamba.ssd_scan(*args, c)) if scan == "op" else \
        (lambda c: tmamba._ssd_chunk_scan(*args, c))
    y16, s16 = fn(16)
    y64, s64 = fn(64)
    torch.testing.assert_close(y16, y64, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(s16, s64, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("scan", ["op", "plain"])
def test_ssd_matches_naive_recurrence(scan):
    """SSD chunked scan == the literal per-step SSM recurrence."""
    b, t, h, p, n = 1, 32, 2, 4, 4
    x, dt, A, Bm, Cm = _ssd_inputs(b, t, h, p, 1, n)
    fn = tmamba.ssd_scan if scan == "op" else tmamba._ssd_chunk_scan
    y, final = fn(x, dt, A, Bm, Cm, 8)
    # naive: S_t = exp(dt_t A) S_{t-1} + dt_t B_t x_t ; y_t = C_t . S_t
    S = np.zeros((b, h, n, p), np.float64)
    ys = []
    xn, dn, An, Bn, Cn = (a.double().numpy() for a in (x, dt, A, Bm, Cm))
    for tt in range(t):
        a = np.exp(dn[:, tt] * An)                                # (b, h)
        upd = dn[:, tt, :, None, None] * Bn[:, tt, 0][:, None, :, None] * xn[:, tt][:, :, None, :]
        S = a[..., None, None] * S + upd
        ys.append(np.einsum("bn,bhnp->bhp", Cn[:, tt, 0], S))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(final.numpy(), S, atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# configs, params, the block and the LM
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    for jc, tc in ((jcfg_mod.CONFIG, tcfg_mod.CONFIG), (JCFG, TCFG)):
        for f in dataclasses.fields(jc):
            if f.name == "ssm":
                assert dataclasses.astuple(tc.ssm) == dataclasses.astuple(jc.ssm)
            else:
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.ssm.d_inner(tc.d_model) == jc.ssm.d_inner(jc.d_model)
        assert tc.ssm.n_heads(tc.d_model) == jc.ssm.n_heads(jc.d_model)
        assert [tc.is_attn_layer(i) for i in range(tc.n_layers)] == \
            [jc.is_attn_layer(i) for i in range(jc.n_layers)] == [False] * tc.n_layers
    full = treg.load_config("mamba2-780m")
    assert full.ssm.d_inner(full.d_model) == 3072 and full.ssm.n_heads(full.d_model) == 48
    segs = tlm.plan_segments(full)
    assert [dataclasses.astuple(s) for s in segs] == \
        [dataclasses.astuple(s) for s in jlm.plan_segments(jcfg_mod.CONFIG)]
    assert len(segs) == 1 and segs[0].repeats == 48 and segs[0].block[0].mixer == "mamba"
    assert treg.with_depth(full, 48) == full and treg.with_depth(full, 2).n_layers == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_convert_leaf_for_leaf(dtype):
    """A Mamba2 tree crosses leaf for leaf; A_log, D and dt_bias stay fp32
    in a bf16 model, in both packages' inits."""
    jcfg = dataclasses.replace(JCFG, dtype=dtype, param_dtype=dtype)
    tcfg = dataclasses.replace(TCFG, dtype=dtype, param_dtype=dtype)
    npp = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    tp = lm_params_from_jax(npp, "cpu")
    got, want = _named(tp), _named(npp)
    assert [n for n, _ in got] == [n for n, _ in want]
    fp32 = ("/A_log", "/D", "/dt_bias")
    for (n, a), (_, b) in zip(got, want):
        assert tuple(a.shape) == b.shape, n
        assert a.dtype == (torch.float32 if n.endswith(fp32) else getattr(torch, dtype)), n
        np.testing.assert_array_equal(a.float().numpy(), b.astype(np.float32), err_msg=n)
    assert "/segments/0/0/mamba/w_in" in dict(got) and "/segments/0/0/norm2/scale" not in dict(got)
    own = treg.bundle_from_cfg(tcfg, "cpu").init(0)
    assert [(n, tuple(a.shape), a.dtype) for n, a in _named(own)] == \
        [(n, tuple(a.shape), a.dtype) for n, a in got]


def test_mamba_block_matches_jax(params):
    _, npp = params
    mp = jax.tree.map(lambda a: a[0], npp["segments"][0][0]["mamba"])    # layer 0
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 64, JCFG.d_model), np.float32)
    g = rng.standard_normal((2, 64, JCFG.d_model), np.float32)

    def jloss(p, u_):
        return jnp.sum(jmamba.mamba_block(p, u_, JCFG) * g)

    jp = jax.tree.map(jnp.asarray, mp)
    want = np.asarray(jmamba.mamba_block(jp, jnp.asarray(u), JCFG))
    jg = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(u))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in mp.items()}
    ut = torch.from_numpy(u).requires_grad_(True)
    got = tmamba.mamba_block(tp, ut, TCFG)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(ut.grad.numpy(), np.asarray(jg[1]), atol=ATOL)
    # a unit cotangent on every output: the param grads sum O(1) terms over
    # all B x T positions and cancel, so they are held normwise
    for k in mp:
        want_k = np.asarray(jg[0][k])
        err = float(np.abs(tp[k].grad.numpy() - want_k).max() / np.abs(want_k).max())
        assert err <= NORM_RTOL, (k, err)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_apply_lm_matches_jax(params, remat):
    jp, npp = params
    batch = _batch()
    want = np.asarray(jlm.apply_lm(jp, jnp.asarray(batch["tokens"]), JCFG, remat=remat))
    launches = (ssd_chunk_fwd.launches, rmsnorm.launches)
    got = tlm.apply_lm(lm_params_from_jax(npp, "cpu"), torch.from_numpy(batch["tokens"]), TCFG,
                       remat=remat)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    assert (ssd_chunk_fwd.launches, rmsnorm.launches) == launches      # CPU: plain versions


@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_and_grads_match_jax(params, remat):
    jp, npp = params
    batch = _batch()
    jl, jg = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG,
                              remat=remat))(jp)
    tp = lm_params_from_jax(npp, "cpu")
    tl, tg = lm_value_and_grad(lambda p, b: tlm.lm_loss(p, b, TCFG, remat=remat), tp, _tb(batch))
    assert abs(float(tl) - float(jl)) <= ATOL * max(1.0, abs(float(jl)))
    got, want = _named(tg), _named(jax.tree.map(np.asarray, jg))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=n)


def _jax_train(accum, steps=3):
    """JAX's trainer for ``steps`` steps: the losses, and the state (params,
    AdamW m and v, as numpy) before each step and after the last."""
    bundle = jreg.bundle_from_cfg(JCFG)
    init_state, step = jtrain.make_train_step(
        bundle, JParallel(grad_accum=accum, remat="full"),
        JTrain(lr=1e-3, warmup=0, steps=steps))
    state = init_state(jax.random.PRNGKey(0))
    specs = bundle.input_specs(JShape("t", 64, 4, "train"))
    step = jax.jit(step)
    states, losses = [], []
    for s in range(steps + 1):
        states.append(jax.tree.map(np.asarray, (state.params, state.opt["m"], state.opt["v"])))
        if s < steps:
            state, m = step(state, jsyn.synth_batch(specs, JCFG, 0, s))
            losses.append(float(m["loss"]))
    return states, losses


@pytest.mark.parametrize("accum", [1, 2])
def test_lm_train_step_matches_jax_trainer(accum):
    """Three steps of the port's trainer against JAX's: the losses of a
    free run within rtol 1e-5, and each step's params taken from JAX's
    state before it (params, AdamW m and v), within PARAM_ATOL of JAX's
    after it - elements in Adam's eps regime held to Adam's step bound, as
    tests/test_torch_lm.py does.  Step from step, because Mamba2's w_in has
    elements whose step-1 gradient is rounding noise (second-moment root
    ~4e-9): their update differs by up to lr between any two fp32
    evaluations, and a free run carries that into every other leaf at the
    next step (measured: embed 1.2e-5 after 3 steps)."""
    states, jlosses = _jax_train(accum)
    arch = treg.bundle_from_cfg(TCFG, "cpu")
    init_state, step = make_train_step(arch, ParallelConfig(grad_accum=accum, remat="full"),
                                       TrainConfig(lr=1e-3, warmup=0, steps=3))
    specs = arch.input_specs(ShapeConfig("t", 64, 4, "train"))

    def batch(s):
        return tsyn.place(tsyn.synth_batch(specs, TCFG, 0, s), "cpu")

    state = init_state(0)._replace(params=lm_params_from_jax(states[0][0], "cpu"))
    losses = []
    for s in range(3):
        state, m = step(state, batch(s))
        losses.append(float(m["loss"]))
    assert state.step == 3 and set(m) == {"loss", "grad_norm", "lr"}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)

    n_ill = n_all = 0
    for s in range(3):
        p, mm, vv = (lm_params_from_jax(t, "cpu") for t in states[s])
        st, _ = step(init_state(0)._replace(params=p, opt={"m": mm, "v": vv, "t": s}, step=s),
                     batch(s))
        got, wanted = _named(st.params), _named(states[s + 1][0])
        assert [n for n, _ in got] == [n for n, _ in wanted]
        roots = [np.sqrt(v.numpy() / (1 - 0.95 ** (s + 1))) for _, v in _named(st.opt["v"])]
        for (n, a), (_, w), root in zip(got, wanted, roots):
            ill = (root > 0) & (root < ADAM_WELL_CONDITIONED)
            d = np.abs(a.numpy() - w)
            assert np.all(d[~ill] < PARAM_ATOL), (s, n, float(d[~ill].max()))
            assert np.all(d[ill] <= 2 * 1e-3 * (1 + 0.1 * np.abs(w[ill]))), (s, n)
            n_ill += int(ill.sum())
            n_all += ill.size
    assert n_ill <= ADAM_ILL_SHARE * n_all, (n_ill, n_all)
    moved = max(float(np.max(np.abs(a - b)))
                for (_, a), (_, b) in zip(_named(states[3][0]), _named(states[0][0])))
    assert moved > 1e-4


def test_mamba_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "mamba2-780m",
         "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "64"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "done: steps=2 restarts=0" in r.stdout and "mamba2-780m layers=2" in r.stdout


def test_mamba_surfaces_that_are_not_ported_raise():
    p = treg.bundle_from_cfg(TCFG, "cpu").init(0)
    mp = {k: v[0] for k, v in p["segments"][0][0]["mamba"].items()}
    # the O(1) decode step runs (tests/test_torch_lm_serve.py holds it against JAX)
    state = tmamba.MambaState.init(1, TCFG, torch.float32)
    y, out = tmamba.mamba_decode(mp, torch.ones((1, 1, TCFG.d_model)), state, TCFG)
    assert y.shape == (1, 1, TCFG.d_model) and out is state and state.length.tolist() == [1]
    assert bool(state.ssm.any()) and bool(state.conv[:, -1].any())
    # the sequence-sharded block and forward run (A.18.8) and match the
    # unsharded ones (tests/test_torch_seq_shard.py holds them against JAX)
    u = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 32, TCFG.d_model))
                         .astype(np.float32))
    tokens = torch.arange(32, dtype=torch.int32)[None] % TCFG.vocab
    with sharding_ctx(make_virtual_mesh({"seq": 2}, "cpu")):
        y = tmamba.mamba_block(mp, u, TCFG, seq_axis="seq")
        h = tlm.apply_lm(p, tokens, TCFG, seq_axis="seq")
    torch.testing.assert_close(y, tmamba.mamba_block(mp, u, TCFG), rtol=0, atol=1e-5)
    torch.testing.assert_close(h, tlm.apply_lm(p, tokens, TCFG), rtol=0, atol=1e-5)
