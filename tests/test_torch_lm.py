"""The port's LM training slice (reduced Qwen2-7B, fp32) against the JAX package.

Params are initialised by JAX and handed over with ``lm_params_from_jax``;
batches come from each package's ``synth_batch`` (which must agree bit for
bit).  On the CPU the flash-attention (B4) and RMSNorm (B6) ops take their
plain versions, and JAX's ``_sdpa`` takes its naive mode (fewer than 2048
keys), the same function.
- ``apply_lm``, ``lm_loss`` (chunked cross-entropy with a padded last
  chunk) and its gradients, remat ``none`` and ``full``, within 1e-5;
- 3 steps of the LM ``make_train_step`` (AdamW, ``grad_accum`` 1 and 2)
  against JAX's, with ``test_torch_train.py``'s bar and AdamW caveat;
- the launcher's LM mode on the CPU; remat "dots" runs, and ``seq_axis`` on
  an attention model raises (ROADMAP C.17).
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

from repro.configs import qwen2_7b as jcfg_mod
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.data import synthetic as jsyn
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.train import trainer as jtrain
from repro_torch.configs import qwen2_7b as tcfg_mod
from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.interop import lm_params_from_jax
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.rmsnorm.kernel import rmsnorm
from repro_torch.launch.mesh import make_virtual_mesh
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.parallel.api import sharding_ctx
from repro_torch.train.trainer import lm_value_and_grad, make_train_step

ATOL = 1e-5          # apply_lm, loss and every grad leaf
PARAM_ATOL = 1e-5    # params after 3 trainer steps (tests/test_torch_train.py)
# tests/test_torch_train.py:ADAM_WELL_CONDITIONED: elements whose AdamW
# second-moment root falls below this are held to Adam's step bound instead.
ADAM_WELL_CONDITIONED = 1e-6
# Share of elements that may be ill-conditioned so.  Higher than the CNN's
# 1e-3: b_k's gradient is zero up to rounding (a key bias shifts every logit
# of a query row alike, which softmax ignores), so most of b_k lands there,
# and the gated MLP has more near-zero grads (measured 166 of 107072
# elements, 30 of them in b_k's 64).
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


def _batch(b=2, t=24, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, JCFG.vocab, (b, t), dtype=np.int32)
    labels = rng.integers(0, JCFG.vocab, (b, t), dtype=np.int32)
    labels[0, :3] = -100           # ignored positions
    return {"tokens": tokens, "labels": labels}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _named(tree, prefix=""):
    """(path, leaf) pairs of a dict/list tree in sorted-key order (JAX's)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def test_configs_match_reference():
    for jc, tc in ((jcfg_mod.CONFIG, tcfg_mod.CONFIG), (JCFG, TCFG)):
        for f in dataclasses.fields(jc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.resolved_head_dim == jc.resolved_head_dim
        assert tc.act_dtype == getattr(torch, jc.dtype) and tc.p_dtype == getattr(torch, jc.param_dtype)
    deep = treg.with_depth(treg.load_config("qwen2-7b"), 12)
    assert deep == dataclasses.replace(tcfg_mod.CONFIG, n_layers=12)
    assert jreg.with_depth(jreg.load_config("qwen2-7b"), 12).n_layers == deep.n_layers
    assert [dataclasses.astuple(s) for s in tlm.plan_segments(deep)] == \
        [dataclasses.astuple(s) for s in jlm.plan_segments(jreg.with_depth(jcfg_mod.CONFIG, 12))]


def test_params_convert_leaf_for_leaf(params):
    jp, npp = params
    tp = lm_params_from_jax(npp, "cpu")
    got, want = _named(tp), _named(npp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, n
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    # the port's own init draws the same tree (keys, shapes, dtypes)
    own = treg.bundle_from_cfg(TCFG, "cpu").init(0)
    assert [(n, tuple(a.shape), a.dtype) for n, a in _named(own)] == \
        [(n, tuple(a.shape), a.dtype) for n, a in got]


@pytest.mark.parametrize("remat", ["none", "full"])
def test_apply_lm_matches_jax(params, remat):
    jp, npp = params
    batch = _batch()
    want = np.asarray(jlm.apply_lm(jp, jnp.asarray(batch["tokens"]), JCFG, remat=remat))
    launches = (flash_attention_fwd.launches, rmsnorm.launches)
    got = tlm.apply_lm(lm_params_from_jax(npp, "cpu"), torch.from_numpy(batch["tokens"]), TCFG,
                       remat=remat)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    assert (flash_attention_fwd.launches, rmsnorm.launches) == launches   # CPU: plain versions


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("ce_chunk", [512, 20])       # 48 tokens: one chunk; 3 with 12 padded
def test_lm_loss_and_grads_match_jax(params, remat, ce_chunk):
    jp, npp = params
    batch = _batch()
    jl, jg = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, JCFG,
                              remat=remat, ce_chunk=ce_chunk))(jp)
    tp = lm_params_from_jax(npp, "cpu")
    tl, tg = lm_value_and_grad(
        lambda p, b: tlm.lm_loss(p, b, TCFG, remat=remat, ce_chunk=ce_chunk), tp, _tb(batch))
    assert abs(float(tl) - float(jl)) <= ATOL * max(1.0, abs(float(jl)))
    got, want = _named(tg), _named(jax.tree.map(np.asarray, jg))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=n)


def test_chunked_cross_entropy_matches_jax():
    rng = np.random.default_rng(7)
    h = rng.standard_normal((3, 10, 16), np.float32)
    w = rng.standard_normal((40, 16), np.float32)
    y = rng.integers(0, 40, (3, 10), dtype=np.int32)
    y[1, 4:] = -100
    for chunk in (7, 30, 512):
        want = float(jlm.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(w), jnp.asarray(y),
                                               chunk=chunk))
        got = float(tlm.chunked_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                              torch.from_numpy(y), chunk=chunk))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), chunk


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 5), (3, 2)])
def test_synth_batch_is_the_reference_stream(seed, step):
    shape = (JShape("t", 32, 4, "train"), ShapeConfig("t", 32, 4, "train"))
    jspecs = jreg.bundle_from_cfg(JCFG).input_specs(shape[0])
    tspecs = treg.bundle_from_cfg(TCFG, "cpu").input_specs(shape[1])
    assert {k: (tuple(s.shape), np.dtype(s.dtype)) for k, s in jspecs.items()} == \
        {k: (tuple(s.shape), np.dtype(s.dtype)) for k, s in tspecs.items()}
    want = jsyn.synth_batch(jspecs, JCFG, seed, step)
    got = tsyn.synth_batch(tspecs, TCFG, seed, step)
    assert set(got) == set(want) == {"tokens", "labels"}
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    placed = tsyn.place(got, "cpu")
    assert all(torch.equal(placed[k], torch.from_numpy(got[k])) for k in got)


def _jax_train(accum, steps=3):
    bundle = jreg.bundle_from_cfg(JCFG)
    init_state, step = jtrain.make_train_step(
        bundle, JParallel(grad_accum=accum, remat="full"),
        JTrain(lr=1e-3, warmup=0, steps=steps))
    state = init_state(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, state.params)
    specs = bundle.input_specs(JShape("t", 16, 4, "train"))
    step = jax.jit(step)
    losses = []
    for s in range(steps):
        state, m = step(state, jsyn.synth_batch(specs, JCFG, 0, s))
        losses.append(float(m["loss"]))
    return params0, jax.tree.map(np.asarray, state.params), losses


@pytest.mark.parametrize("accum", [1, 2])
def test_lm_train_step_matches_jax_trainer(accum):
    params0, want, jlosses = _jax_train(accum)
    arch = treg.bundle_from_cfg(TCFG, "cpu")
    init_state, step = make_train_step(arch, ParallelConfig(grad_accum=accum, remat="full"),
                                       TrainConfig(lr=1e-3, warmup=0, steps=3))
    state = init_state(0)
    state = state._replace(params=lm_params_from_jax(params0, "cpu"))
    specs = arch.input_specs(ShapeConfig("t", 16, 4, "train"))
    losses, vs = [], []
    for s in range(3):
        state, m = step(state, tsyn.place(tsyn.synth_batch(specs, TCFG, 0, s), "cpu"))
        losses.append(float(m["loss"]))
        vs.append([v.clone() for v in tree_leaves(state.opt["v"])])   # updated in place
    assert state.step == 3 and set(m) == {"loss", "grad_norm", "lr"}
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    # AdamW caveat (tests/test_torch_train.py): elements whose second-moment
    # root fell below ADAM_WELL_CONDITIONED at some step are held to Adam's
    # step bound, and must stay rare; every other element to PARAM_ATOL.  A
    # root of exactly 0 (embedding rows of tokens absent from every batch:
    # a zero grad in both packages) is no ill condition - those rows take
    # the weight decay alone and are held to PARAM_ATOL.
    got, wanted = _named(state.params), _named(want)
    assert [n for n, _ in got] == [n for n, _ in wanted]
    n_ill = n_all = 0
    for i, ((n, p), (_, w)) in enumerate(zip(got, wanted)):
        ill = np.zeros(w.shape, bool)
        for t, v in enumerate(vs, start=1):
            root = np.sqrt(v[i].numpy() / (1 - 0.95 ** t))
            ill |= (root > 0) & (root < ADAM_WELL_CONDITIONED)
        d = np.abs(p.numpy() - w)
        assert np.all(d[~ill] < PARAM_ATOL), (n, float(d[~ill].max()))
        assert np.all(d[ill] <= 2 * 3 * 1e-3 * (1 + 0.1 * np.abs(w[ill]))), n
        n_ill += int(ill.sum())
        n_all += ill.size
    assert n_ill <= ADAM_ILL_SHARE * n_all, (n_ill, n_all)
    moved = max(float(np.max(np.abs(a - b))) for a, b in zip(_leaves_np(want), _leaves_np(params0)))
    assert moved > 1e-4


def test_lm_train_step_grads_are_the_microbatch_mean():
    """grad_accum 2: on_grads sees fp32 sums divided once, the loss is the
    mean of the microbatches' losses."""
    arch = treg.bundle_from_cfg(TCFG, "cpu")
    batch = tsyn.place(tsyn.synth_batch(arch.input_specs(ShapeConfig("t", 8, 4, "train")),
                                        TCFG, 0, 0), "cpu")
    seen = {}
    init_state, step = make_train_step(
        arch, ParallelConfig(grad_accum=2), TrainConfig(warmup=0, steps=1),
        on_grads=lambda s, l, g: seen.update(loss=float(l), g=[x.clone() for x in tree_leaves(g)]))
    state = init_state(0)
    params = tree_leaves(state.params)
    halves = [lm_value_and_grad(lambda p, b: arch.loss_fn(p, b), state.params,
                                {k: v[i * 2:(i + 1) * 2] for k, v in batch.items()})
              for i in range(2)]
    want_g = [(a.float() + b.float()) / 2 for a, b in
              zip(tree_leaves(halves[0][1]), tree_leaves(halves[1][1]))]
    step(state, batch)
    assert seen["loss"] == pytest.approx(float(halves[0][0] + halves[1][0]) / 2, rel=1e-6)
    for g, w, p in zip(seen["g"], want_g, params):
        assert g.dtype == torch.float32 and torch.equal(g, w)


def test_lm_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen2-7b", "--device", "cpu",
         "--steps", "2", "--batch", "2", "--seq", "32"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "done: steps=2 restarts=0" in r.stdout and "qwen2-7b layers=2" in r.stdout


def test_lm_surfaces_that_are_not_ported_raise():
    # DeepSeek-V3 (A.18.4) and Qwen2-VL (A.18.5) resolve now
    # (tests/test_torch_deepseek.py and test_torch_vlm.py hold them against
    # JAX); remat "dots" (A.18.9) runs (tests/test_torch_remat_dots.py), and
    # the sequence-sharded forward (A.18.8) refuses attention layers (C.17)
    assert treg.load_config("deepseek-v3-671b").mla is not None
    assert treg.load_config("qwen2-vl-2b").mrope_sections == (16, 24, 24)
    with pytest.raises(ValueError, match="unknown arch"):
        treg.load_config("gpt-5")
    arch = treg.bundle_from_cfg(TCFG, "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    p = arch.init(0)
    # the serving surface runs (tests/test_torch_lm_serve.py holds it against JAX)
    caches = arch.make_caches(1, 8)
    logits, out = arch.decode_fn(p, tokens[:, :1], caches)
    assert logits.shape == (1, 1, TCFG.vocab) and logits.dtype == torch.float32
    assert out[0] is caches[0] and caches[0].lengths.tolist() == [1]
    assert torch.equal(tlm.apply_lm(p, tokens, TCFG, remat="dots"), tlm.apply_lm(p, tokens, TCFG))
    with sharding_ctx(make_virtual_mesh({"seq": 2}, "cpu")):
        with pytest.raises(ValueError, match=r"layer 0 is attention.*C\.17"):
            tlm.apply_lm(p, tokens, TCFG, seq_axis="seq")
    # M-RoPE runs: at the default positions (three arange streams) it is
    # plain RoPE, so the forward keeps its bits
    mrope = tlm.apply_lm(p, tokens, dataclasses.replace(TCFG, mrope_sections=(2, 3, 3)))
    assert torch.equal(mrope, tlm.apply_lm(p, tokens, TCFG))


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        treg.get_arch("qwen2-7b", reduced=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_jax({"embed": np.zeros((2, 2), np.float32)})


@pytest.mark.parametrize("name", ["adamw", "sgd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inplace_updates_equal_the_out_of_place_ones(name, dtype):
    """The LM trainer's in-place clipping and optimizer updates give the
    same bits as the reference-shaped out-of-place ones."""
    from repro_torch.optim import optimizers as topt

    rng = np.random.default_rng(9)

    def tree():
        return {"a": torch.from_numpy(rng.standard_normal((5, 7), np.float32)).to(dtype),
                "b": [torch.from_numpy(rng.standard_normal((3,), np.float32)).to(dtype)]}

    params, grads = tree(), [tree() for _ in range(3)]
    outs = []
    for inplace in (False, True):
        opt = topt.make_optimizer(name, inplace=inplace)
        p = topt.tree_map(torch.clone, params)
        st = opt.init(p)
        for g in grads:
            g, _ = topt.clip_by_global_norm(topt.tree_map(torch.clone, g), 0.5, inplace=inplace)
            p, st = opt.update(g, st, p, 1e-2)
        outs.append(tree_leaves(p) + tree_leaves({k: v for k, v in st.items() if k != "t"}))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)
