"""The three dense configs of ROADMAP A.18.2 - StableLM-2-1.6B (LayerNorm,
partial rotary), CodeQwen1.5-7B (MHA, QKV bias) and Command-R 35B
(LayerNorm, parallel attention||MLP block, tied embeddings) - at their
reduced configs, fp32, against the JAX package.

Params are initialised by JAX and handed over with ``lm_params_from_jax``.
At init every bias is zero and every norm scale one, which would leave the
bias and LayerNorm branches unexercised, so the biases and norm leaves get
the same seeded numpy noise in both packages first (``_perturbed``).  On
the CPU the flash-attention (B4) and RMSNorm (B6) ops take their plain
versions.
- the configs field by field, and the params leaf for leaf;
- ``apply_lm``, ``lm_loss`` and its grads, remat ``none`` and ``full``,
  within ``tests/test_torch_lm.py``'s 1e-5;
- ``decode_step``'s logits and cache leaves against JAX's decode, from two
  slots at unequal lengths, within 1e-5; decode against the port's full
  forward at the reference's bar (``tests/test_attention.py:94-96``);
- ``ServeEngine``'s greedy answers against a greedy loop over the
  reference's ``apply_lm`` per prompt;
- 3 steps of the LM ``make_train_step`` (AdamW) against JAX's, with
  ``tests/test_torch_lm.py``'s bar and AdamW caveat;
- both launchers on the CPU for each id.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.data import synthetic as jsyn
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.train import trainer as jtrain
from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.interop import lm_caches_from_jax, lm_params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serve import engine as teng
from repro_torch.train.trainer import lm_value_and_grad, make_train_step

ATOL = 1e-5                                  # tests/test_torch_lm.py
PARAM_ATOL = 1e-5
ADAM_WELL_CONDITIONED = 1e-6                 # tests/test_torch_lm.py's AdamW caveat
ADAM_ILL_SHARE = 5e-3
DECODE_BAR = dict(atol=2e-2, rtol=2e-2)      # tests/test_attention.py:94-96
REF_LEN = 64                                 # the greedy reference's padded length
# id -> the config module's name in both packages
IDS = {
    "stablelm-1.6b": "stablelm_1_6b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "command-r-35b": "command_r_35b",
}


def _mods(name):
    mod = IDS[name]
    return (importlib.import_module(f"repro.configs.{mod}"),
            importlib.import_module(f"repro_torch.configs.{mod}"))


def _cfgs(name):
    jm, tm = _mods(name)
    return jm.reduced(), tm.reduced()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _perturbed(tree):
    """Every bias (``b_*``) and norm leaf (``scale``, ``bias``) plus seeded
    noise, the rest as given: numpy in, numpy out."""
    rng = np.random.default_rng(11)

    def leaf(path, a):
        key = jax.tree_util.keystr(path)
        if "['b_" in key or "norm" in key:
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


_PARAMS = {}


def _params(name):
    """(JAX params, the same as numpy, the port's) of the reduced config,
    seed 0, perturbed."""
    if name not in _PARAMS:
        jcfg, _ = _cfgs(name)
        npp = _perturbed(jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), jcfg)))
        _PARAMS[name] = (jax.tree.map(jnp.asarray, npp), npp, lm_params_from_jax(npp, "cpu"))
    return _PARAMS[name]


def _named(tree, prefix=""):
    """(path, leaf) pairs of a dict/list tree in sorted-key order (JAX's)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _named(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _named(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _batch(vocab, b=2, t=24, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, t), dtype=np.int32)
    labels = rng.integers(0, vocab, (b, t), dtype=np.int32)
    labels[0, :3] = -100
    return {"tokens": tokens, "labels": labels}


# ---------------------------------------------------------------------------
# configs and params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(IDS))
def test_config_matches_the_reference(name):
    jm, tm = _mods(name)
    assert treg.load_config(name) == tm.CONFIG
    assert treg.load_config(name, reduced=True) == tm.reduced()
    for jc, tc in ((jm.CONFIG, tm.CONFIG), (jm.reduced(), tm.reduced())):
        for f in dataclasses.fields(jc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.resolved_head_dim == jc.resolved_head_dim
        assert tc.act_dtype == getattr(torch, jc.dtype)
        assert tc.p_dtype == getattr(torch, jc.param_dtype)
        assert [dataclasses.astuple(s) for s in tlm.plan_segments(tc)] == \
            [dataclasses.astuple(s) for s in jlm.plan_segments(jc)]
    # the rotated width, as both packages round it (even): StableLM's head
    # dim x 0.25 - 16 of 64 at full width, 4 of 16 reduced; the whole head
    # elsewhere
    for tc, want in ((tm.CONFIG, 16), (tm.reduced(), 4)):
        rot = int(tc.resolved_head_dim * tc.rope_pct)
        assert rot - rot % 2 == (want if name == "stablelm-1.6b" else tc.resolved_head_dim)


@pytest.mark.parametrize("name", list(IDS))
def test_params_convert_leaf_for_leaf(name):
    _, npp, tp = _params(name)
    _, tcfg = _cfgs(name)
    got, want = _named(tp), _named(npp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, n
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    names = [n for n, _ in got]
    assert ("/lm_head" in names) == (not tcfg.tie_embeddings)
    assert any(n.endswith("norm1/bias") for n in names) == (tcfg.norm == "layernorm")
    assert any(n.endswith("attn/b_v") for n in names) == tcfg.qkv_bias
    assert any("norm2" in n for n in names) == (not tcfg.parallel_block)
    # the port's own init draws the same tree (keys, shapes, dtypes)
    own = treg.bundle_from_cfg(tcfg, "cpu").init(0)
    assert [(n, tuple(a.shape), a.dtype) for n, a in _named(own)] == \
        [(n, tuple(a.shape), a.dtype) for n, a in got]


# ---------------------------------------------------------------------------
# forward, loss and grads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("name", list(IDS))
def test_apply_lm_loss_and_grads_match_jax(name, remat):
    jcfg, tcfg = _cfgs(name)
    jp, _, tp = _params(name)
    batch = _batch(jcfg.vocab)
    want = np.asarray(jlm.apply_lm(jp, jnp.asarray(batch["tokens"]), jcfg, remat=remat))
    got = tlm.apply_lm(tp, torch.from_numpy(batch["tokens"]), tcfg, remat=remat)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL)
    jl, jg = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                              remat=remat, ce_chunk=20))(jp)
    tl, tg = lm_value_and_grad(
        lambda p, b: tlm.lm_loss(p, b, tcfg, remat=remat, ce_chunk=20), tp,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= ATOL * max(1.0, abs(float(jl)))
    got, want = _named(tg), _named(jax.tree.map(np.asarray, jg))
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL, err_msg=n)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(IDS))
def test_decode_step_and_caches_match_jax(name):
    """As ``tests/test_torch_lm_serve.py``: two slots after 7 decoded tokens,
    set to lengths 3 and 7, then 12 steps."""
    jcfg, tcfg = _cfgs(name)
    jp, _, tp = _params(name)
    rng = np.random.default_rng(1)
    dec = jax.jit(lambda c, t: jlm.decode_step(jp, t, c, jcfg))
    jc = jlm.init_caches(jcfg, 2, 24, jcfg.act_dtype)
    for _ in range(7):
        _, jc = dec(jc, jnp.asarray(rng.integers(0, jcfg.vocab, (2, 1), dtype=np.int32)))
    jc = [c._replace(lengths=jnp.asarray([3, 7], jnp.int32)) for c in jc]
    tc = lm_caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    for step in range(12):
        tok = rng.integers(0, jcfg.vocab, (2, 1), dtype=np.int32)
        jl, jc = dec(jc, jnp.asarray(tok))
        tl, _ = tlm.decode_step(tp, torch.from_numpy(tok), tc, tcfg)
        assert tl.dtype == torch.float32 and tl.shape == (2, 1, tcfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0,
                                   err_msg=f"logits, step {step}")
        for i, (a, b) in enumerate(zip(jax.tree.leaves(jc), [t for c in tc for t in c])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0,
                                       err_msg=f"cache leaf {i}, step {step}")


@pytest.mark.parametrize("name", list(IDS))
def test_decode_matches_the_full_forward(name):
    _, tcfg = _cfgs(name)
    _, _, tp = _params(name)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab, (2, 14),
                                                                 dtype=np.int32))
    full = (tlm.apply_lm(tp, tokens, tcfg) @ tlm.lm_head_weight(tp, tcfg).T).float()
    caches = treg.bundle_from_cfg(tcfg, "cpu").make_caches(2, 14)
    outs = [tlm.decode_step(tp, tokens[:, t:t + 1], caches, tcfg)[0][:, 0] for t in range(14)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), **DECODE_BAR)


@pytest.mark.parametrize("name", list(IDS))
def test_engine_greedy_answers_equal_the_reference_forward_per_prompt(name):
    """5 requests over 2 slots, unequal prompt and answer lengths, so slots
    recycle: each answer is the greedy continuation of its prompt alone by
    the reference's full forward."""
    jcfg, tcfg = _cfgs(name)
    jp, _, tp = _params(name)
    eng = teng.ServeEngine(treg.bundle_from_cfg(tcfg, "cpu"), tp, batch=2, max_seq=32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, size=int(rng.integers(3, 10))).astype(np.int32)
               for _ in range(5)]
    news = [5, 3, 6, 2, 4]
    for rid, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=n))
    done = eng.run(max_ticks=200)
    assert sorted(r.rid for r in done) == list(range(5))

    @jax.jit
    def logits_at(tokens):
        hidden = jlm.apply_lm(jp, tokens, jcfg)
        return (hidden[0] @ jlm.lm_head_weight(jp, jcfg).T).astype(jnp.float32)

    for r in done:
        seq = [int(t) for t in r.prompt]
        for _ in range(news[r.rid]):
            buf = np.zeros((1, REF_LEN), np.int32)
            buf[0, :len(seq)] = seq
            seq.append(int(jnp.argmax(logits_at(jnp.asarray(buf))[len(seq) - 1])))
        assert r.out_tokens == seq[len(r.prompt):], r.rid


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _jax_train(name, accum, steps=3):
    jcfg, _ = _cfgs(name)
    bundle = jreg.bundle_from_cfg(jcfg)
    init_state, step = jtrain.make_train_step(
        bundle, JParallel(grad_accum=accum, remat="full"), JTrain(lr=1e-3, warmup=0, steps=steps))
    state = init_state(jax.random.PRNGKey(0))
    params0 = _perturbed(jax.tree.map(np.asarray, state.params))
    state = state._replace(params=jax.tree.map(jnp.asarray, params0))
    specs = bundle.input_specs(JShape("t", 16, 4, "train"))
    step = jax.jit(step)
    losses = []
    for s in range(steps):
        state, m = step(state, jsyn.synth_batch(specs, jcfg, 0, s))
        losses.append(float(m["loss"]))
    return params0, jax.tree.map(np.asarray, state.params), losses


@pytest.mark.parametrize("name,accum", [("stablelm-1.6b", 1), ("codeqwen1.5-7b", 1),
                                        ("command-r-35b", 2)])
def test_lm_train_step_matches_jax_trainer(name, accum):
    """``tests/test_torch_lm.py``'s trainer case.  Command-R's tied
    embedding takes gradient from the lookup and the head as one leaf."""
    params0, want, jlosses = _jax_train(name, accum)
    _, tcfg = _cfgs(name)
    arch = treg.bundle_from_cfg(tcfg, "cpu")
    init_state, step = make_train_step(arch, ParallelConfig(grad_accum=accum, remat="full"),
                                       TrainConfig(lr=1e-3, warmup=0, steps=3))
    state = init_state(0)._replace(params=lm_params_from_jax(params0, "cpu"))
    specs = arch.input_specs(ShapeConfig("t", 16, 4, "train"))
    losses, vs = [], []
    for s in range(3):
        state, m = step(state, tsyn.place(tsyn.synth_batch(specs, tcfg, 0, s), "cpu"))
        losses.append(float(m["loss"]))
        vs.append([v.clone() for v in tree_leaves(state.opt["v"])])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got, wanted = _named(state.params), _named(want)
    assert [n for n, _ in got] == [n for n, _ in wanted]
    assert ("/lm_head" in dict(got)) == (not tcfg.tie_embeddings)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inplace_adamw_by_slices_gives_the_out_of_place_bits(monkeypatch, dtype):
    """The in-place AdamW updates a leaf ``INPLACE_CHUNK`` elements at a
    time (so a tied 256000-row embedding's temporaries stay small): slices
    that split leaves unevenly give the out-of-place update's bits."""
    from repro_torch.optim import optimizers as topt

    monkeypatch.setattr(topt, "INPLACE_CHUNK", 7)
    rng = np.random.default_rng(12)

    def tree():
        return {"embed": torch.from_numpy(rng.standard_normal((9, 5), np.float32)).to(dtype),
                "b": [torch.from_numpy(rng.standard_normal((3,), np.float32)).to(dtype)]}

    params, grads = tree(), [tree() for _ in range(3)]
    outs = []
    for inplace in (False, True):
        opt = topt.make_optimizer("adamw", inplace=inplace)
        p = topt.tree_map(torch.clone, params)
        st = opt.init(p)
        for g in grads:
            p, st = opt.update(topt.tree_map(lambda x: x.float(), g), st, p, 1e-2)
        outs.append(tree_leaves(p) + tree_leaves({k: v for k, v in st.items() if k != "t"}))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(IDS))
def test_launchers_run_each_id_on_cpu(name, capsys):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    assert train_main(["--arch", name, "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "32"]) == 0
    out = capsys.readouterr().out
    assert f"model: {name} layers=2" in out and "done: steps=2 restarts=0" in out
    assert serve_main(["--device", "cpu", "--arch", name, "--requests", "3", "--slots", "2",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


def test_train_launcher_defaults_to_stablelm(capsys):
    """The reference's default ``--arch`` (``repro/launch/train.py:43``)."""
    from repro_torch.launch.train import main

    assert main(["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "16"]) == 0
    assert "model: stablelm-1.6b layers=2" in capsys.readouterr().out
