"""The two Mixture-of-Experts configs of ROADMAP A.18.3 - Mixtral-8x22B
(MoE on every layer, sliding window) and Jamba-v0.1-52B (Mamba layers,
one attention layer without RoPE per period of 8, MoE on odd layers) - at
their reduced configs, fp32, against the JAX package.

Params are initialised by JAX and handed over with ``lm_params_from_jax``;
every norm leaf gets the same seeded numpy noise in both packages first
(at init they are all ones).  On the CPU the flash-attention (B4), SSD
(B5) and RMSNorm (B6) ops take their plain versions.
- the configs field by field, their segments, and the params leaf for leaf
  (an MoE layer holds ``moe`` and no dense ``mlp``; the router is fp32);
- ``apply_lm``, ``lm_loss`` and its grads, remat ``none`` and ``full``,
  within ``tests/test_torch_lm.py``'s 1e-5 or, where Jamba's fp32 rounding
  parts the two packages by more, by FP64_RULE (below) (past Mixtral's
  window of 16), with ample capacity and with a capacity that drops
  assignments; the loss has no router aux term, in either package;
- ``decode_step``'s logits and cache leaves against JAX's decode, within
  1e-5 or by FP64_RULE; decode against the port's full forward at the
  reference's bar;
- ``ServeEngine``'s greedy answers against a greedy loop over the
  reference's ``apply_lm`` per prompt, and a request beside others giving
  the logits and tokens it gives alone, bit for bit;
- which KV caches bound the positions the engine takes;
- 3 steps of the LM ``make_train_step`` with AdamW and with adafactor
  against JAX's trainer;
- both launchers on the CPU for each id, training with adafactor.
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
# FP64_RULE.  A tensor that misses ATOL (a param leaf after training:
# PARAM_ATOL on a well-conditioned element) is held instead against an fp64
# evaluation of the port on the same inputs: JAX's tensor within NORM_RTOL
# of the largest entry (activations, grads, caches: tests/test_torch_mamba2.py's
# normwise fp32 rtol) or, for params, within PARAM_ATOL in RMS of it, and the
# port's RMS distance from it no more than FP64_FACTOR x JAX's.  Jamba's 8
# reduced layers (MoE activations in the hundreds between the norms) put
# JAX's fp32 forward ~6e-5 from fp64 and the port's ~4e-5, so the two fp32
# evaluations part by more than 1e-5 there.
NORM_RTOL = 1e-4
FP64_FACTOR = 2.0
ADAM_WELL_CONDITIONED = 1e-6                 # tests/test_torch_lm.py's AdamW caveat
ADAM_ILL_SHARE = 5e-3
DECODE_BAR = dict(atol=2e-2, rtol=2e-2)      # tests/test_attention.py:94-96
REF_LEN = 64                                 # the greedy reference's padded length
TIGHT_CF = 0.5                               # a capacity factor that drops assignments
IDS = {"mixtral-8x22b": "mixtral_8x22b", "jamba-v0.1-52b": "jamba_v0_1_52b"}


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
    """Every norm leaf plus seeded noise, the rest as given: numpy in, numpy
    out."""
    rng = np.random.default_rng(11)

    def leaf(path, a):
        if "norm" in jax.tree_util.keystr(path):
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


def _batch(vocab, b=2, t=32, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, t), dtype=np.int32)
    labels = rng.integers(0, vocab, (b, t), dtype=np.int32)
    labels[0, :3] = -100
    return {"tokens": tokens, "labels": labels}


def _fp64(tree):
    return jax.tree.map(lambda t: t.double() if t.is_floating_point() else t, tree)


def _cfg64(cfg):
    return dataclasses.replace(cfg, dtype="float64", param_dtype="float64")


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _close(got, want, exact, what):
    """``got`` (the port, fp32) against ``want`` (JAX, fp32): within ATOL,
    or by FP64_RULE against ``exact`` (the port in fp64)."""
    d = float(np.abs(got - want).max())
    if d <= ATOL:
        return
    assert float(np.abs(want - exact).max()) <= NORM_RTOL * float(np.abs(want).max()), (what, d)
    assert _rms(got - exact) <= FP64_FACTOR * _rms(want - exact), (what, d)


def _tight(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=TIGHT_CF))


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
            want = getattr(jc, f.name)
            got = getattr(tc, f.name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
            else:
                assert got == want, f.name
        assert tc.act_dtype == getattr(torch, jc.dtype)
        assert [dataclasses.astuple(s) for s in tlm.plan_segments(tc)] == \
            [dataclasses.astuple(s) for s in jlm.plan_segments(jc)]
        assert [dataclasses.astuple(tlm.layer_kind(tc, i)) for i in range(tc.n_layers)] == \
            [dataclasses.astuple(jlm.layer_kind(jc, i)) for i in range(jc.n_layers)]
    kinds = [tlm.layer_kind(tm.CONFIG, i) for i in range(tm.CONFIG.n_layers)]
    if name == "mixtral-8x22b":
        assert all(k.mixer == "attn" and k.moe and k.swa for k in kinds)
    else:   # attention at offset 4 of each period of 8, MoE on the odd layers
        assert [i for i, k in enumerate(kinds) if k.mixer == "attn"] == [4, 12, 20, 28]
        assert [i for i, k in enumerate(kinds) if k.moe] == list(range(1, 32, 2))
        assert not tm.CONFIG.use_rope and not any(k.swa for k in kinds)


@pytest.mark.parametrize("name", list(IDS))
def test_params_convert_leaf_for_leaf(name):
    _, npp, tp = _params(name)
    _, tcfg = _cfgs(name)
    got, want = _named(tp), _named(npp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, n
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    # an MoE layer holds its experts and no dense MLP beside them
    kinds = [k for seg in tlm.plan_segments(tcfg) for k in seg.block]
    layers = [layer for seg in tp["segments"] for layer in seg]
    assert len(kinds) == len(layers) and any(k.moe for k in kinds)
    for kind, layer in zip(kinds, layers):
        assert ("moe" in layer) == kind.moe != ("mlp" in layer) and "norm2" in layer
        if kind.moe:
            assert set(layer["moe"]) == {"router", "w_gate", "w_up", "w_down"}
    # the port's own init draws the same tree (keys, shapes, dtypes), the
    # router in fp32 in a bf16 model too
    own = treg.bundle_from_cfg(tcfg, "cpu").init(0)
    assert [(n, tuple(a.shape), a.dtype) for n, a in _named(own)] == \
        [(n, tuple(a.shape), a.dtype) for n, a in got]
    bf16 = dataclasses.replace(tcfg, dtype="bfloat16", param_dtype="bfloat16")
    for n, a in _named(treg.bundle_from_cfg(bf16, "cpu").init(0)):
        assert a.dtype == (torch.float32 if n.endswith("router") or "A_log" in n or
                           n.endswith("/D") or "dt_bias" in n else torch.bfloat16), n


# ---------------------------------------------------------------------------
# forward, loss and grads
# ---------------------------------------------------------------------------


def _forward_loss_grads(name, remat, tight=False, b=2, t=32):
    jcfg, tcfg = _cfgs(name)
    if tight:
        jcfg, tcfg = _tight(jcfg), _tight(tcfg)
    jp, _, tp = _params(name)
    batch = _batch(jcfg.vocab, b=b, t=t)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = np.asarray(jlm.apply_lm(jp, jnp.asarray(batch["tokens"]), jcfg, remat=remat))
    got = tlm.apply_lm(tp, tb["tokens"], tcfg, remat=remat)
    exact = tlm.apply_lm(_fp64(tp), tb["tokens"], _cfg64(tcfg), remat=remat)
    _close(got.detach().numpy(), want, exact.detach().numpy(), "apply_lm")
    jl, jg = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                              remat=remat, ce_chunk=20))(jp)
    tl, tg = lm_value_and_grad(
        lambda p, bt: tlm.lm_loss(p, bt, tcfg, remat=remat, ce_chunk=20), tp, tb)
    _, g64 = lm_value_and_grad(
        lambda p, bt: tlm.lm_loss(p, bt, _cfg64(tcfg), remat=remat, ce_chunk=20), _fp64(tp), tb)
    assert abs(float(tl) - float(jl)) <= ATOL * max(1.0, abs(float(jl)))
    got, want, exact = _named(tg), _named(jax.tree.map(np.asarray, jg)), _named(g64)
    assert [n for n, _ in got] == [n for n, _ in want] == [n for n, _ in exact]
    for (n, a), (_, w), (_, e) in zip(got, want, exact):
        _close(a.numpy(), w, e.numpy(), n)
    return tcfg, tp, batch, float(tl)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("name", list(IDS))
def test_apply_lm_loss_and_grads_match_jax(name, remat):
    """Two sequences of 32 tokens: 128 assignments, the dropless floor."""
    tcfg, tp, batch, loss = _forward_loss_grads(name, remat)
    # lm_loss adds no router aux term (the reference's adds none either)
    hidden = tlm.apply_lm(tp, torch.from_numpy(batch["tokens"]), tcfg)
    ce = tlm.chunked_cross_entropy(hidden, tlm.lm_head_weight(tp, tcfg),
                                   torch.from_numpy(batch["labels"]), chunk=20)
    assert float(ce) == pytest.approx(loss, rel=1e-6)
    assert float(tlm.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
                             aux_weight=10.0, ce_chunk=20)) == pytest.approx(loss, rel=1e-6)


@pytest.mark.parametrize("name", list(IDS))
def test_apply_lm_loss_and_grads_match_jax_when_capacity_drops(name):
    """Capacity factor 0.5 at 2 x 160 tokens: 640 assignments, past the
    dropless floor, 80 slots an expert - the same assignments drop in both
    packages, or the outputs would part."""
    from repro_torch.models import mlp as tmlp

    tcfg, tp, batch, _ = _forward_loss_grads(name, "full", tight=True, t=160)
    assert tmlp.moe_capacity(320, tcfg.moe) == 80
    seen = []
    real = tmlp.queue_positions

    def spy(topi, e, cap):
        pos, keep = real(topi, e, cap)
        seen.append(float(keep.float().mean()))
        return pos, keep

    tmlp.queue_positions = spy
    try:
        tlm.apply_lm(tp, torch.from_numpy(batch["tokens"]), tcfg)
    finally:
        tmlp.queue_positions = real
    assert seen and min(seen) < 1.0, seen


def test_mixtral_past_its_window_matches_jax():
    """One sequence of 48 tokens, three times the reduced window of 16."""
    jcfg, tcfg = _cfgs("mixtral-8x22b")
    assert tcfg.swa_window == 16
    jp, _, tp = _params("mixtral-8x22b")
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (1, 48), dtype=np.int32)
    want = np.asarray(jlm.apply_lm(jp, jnp.asarray(tokens), jcfg))
    got = tlm.apply_lm(tp, torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # the window bites: without it the port's forward moves past the bar
    wide = tlm.apply_lm(tp, torch.from_numpy(tokens), dataclasses.replace(tcfg, swa_window=None))
    assert float((wide - got).abs().max()) > 100 * ATOL


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(IDS))
def test_decode_step_and_caches_match_jax(name):
    """As ``tests/test_torch_dense_configs.py``: two slots after 7 decoded
    tokens, the KV slots set to lengths 3 and 7, then 12 steps (past
    Mixtral's window of 16; a Mamba2 state has one length in JAX)."""
    jcfg, tcfg = _cfgs(name)
    jp, _, tp = _params(name)
    rng = np.random.default_rng(1)
    dec = jax.jit(lambda c, t: jlm.decode_step(jp, t, c, jcfg))
    jc = jlm.init_caches(jcfg, 2, 24, jcfg.act_dtype)
    for _ in range(7):
        _, jc = dec(jc, jnp.asarray(rng.integers(0, jcfg.vocab, (2, 1), dtype=np.int32)))
    jc = [c._replace(lengths=jnp.asarray([3, 7], jnp.int32)) if hasattr(c, "lengths") else c
          for c in jc]
    tc = lm_caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    tc64 = [type(c)(*(t.double() if t.is_floating_point() else t.clone() for t in c))
            for c in tc]
    tp64, cfg64 = _fp64(tp), _cfg64(tcfg)
    for step in range(12):
        tok = rng.integers(0, jcfg.vocab, (2, 1), dtype=np.int32)
        jl, jc = dec(jc, jnp.asarray(tok))
        tl, _ = tlm.decode_step(tp, torch.from_numpy(tok), tc, tcfg)
        tl64, _ = tlm.decode_step(tp64, torch.from_numpy(tok), tc64, cfg64)
        assert tl.dtype == torch.float32 and tl.shape == (2, 1, tcfg.vocab)
        _close(tl.numpy(), np.asarray(jl), tl64.numpy(), f"logits, step {step}")
        leaves = zip(jax.tree.leaves(jc), [t for c in tc for t in c], [t for c in tc64 for t in c])
        for i, (a, b, e) in enumerate(leaves):
            a = np.asarray(a)
            if a.ndim == 0:          # JAX's one Mamba2 length, the port's per slot
                a = np.broadcast_to(a, b.shape)
            _close(b.numpy(), a, e.numpy(), f"cache leaf {i}, step {step}")


@pytest.mark.parametrize("name", list(IDS))
def test_decode_matches_the_full_forward(name):
    """One sequence of 48 tokens (past Mixtral's window): 96 assignments, so
    the forward, like every decode, is dropless."""
    _, tcfg = _cfgs(name)
    _, _, tp = _params(name)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab, (1, 48),
                                                                 dtype=np.int32))
    full = (tlm.apply_lm(tp, tokens, tcfg) @ tlm.lm_head_weight(tp, tcfg).T).float()
    caches = treg.bundle_from_cfg(tcfg, "cpu").make_caches(1, 48)
    outs = [tlm.decode_step(tp, tokens[:, t:t + 1], caches, tcfg)[0][:, 0] for t in range(48)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), **DECODE_BAR)


@pytest.mark.parametrize("name", list(IDS))
def test_engine_greedy_answers_equal_the_reference_forward_per_prompt(name):
    """5 requests over 2 slots, unequal prompt and answer lengths, so slots
    recycle: each answer is the greedy continuation of its prompt alone by
    the reference's full forward (at REF_LEN tokens, dropless)."""
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


def _served(arch, params, reqs, target):
    """The target request's logits at each tick and its answer, from a
    3-slot engine serving ``reqs`` ((rid, prompt, new) triples)."""
    eng = teng.ServeEngine(arch, params, batch=3, max_seq=32)
    seen = []
    real = teng.sample_logits

    def record(logits, generator, temperature):
        slot = [i for i, r in enumerate(eng.slots) if r is not None and r.rid == target]
        if slot:
            seen.append(logits[slot[0], -1].clone())
        return real(logits, generator, temperature)

    teng.sample_logits = record
    try:
        for rid, p, n in reqs:
            eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=n))
        done = {r.rid: r for r in eng.run()}
    finally:
        teng.sample_logits = real
    return torch.stack(seen), done[target].out_tokens


@pytest.mark.parametrize("name", list(IDS))
def test_a_request_beside_others_gives_its_bits_alone(name):
    """The slots share the experts' dispatch buffers; a decode call of 3
    slots is dropless (6 assignments), and each row's expert rows are
    computed on their own, so a request admitted into a recycled slot beside
    two others gives the logits and tokens it gives alone, bit for bit."""
    _, tcfg = _cfgs(name)
    _, _, tp = _params(name)
    arch = treg.bundle_from_cfg(tcfg, "cpu")
    rng = np.random.default_rng(19)
    p = [rng.integers(0, tcfg.vocab, size=n).astype(np.int32) for n in (5, 9, 7, 11)]
    got, got_toks = _served(arch, tp, [(0, p[0], 3), (1, p[1], 12), (2, p[2], 12),
                                       (3, p[3], 8)], 3)
    want, want_toks = _served(arch, tp, [(3, p[3], 8)], 3)
    assert got.shape == want.shape == (8, tcfg.vocab)
    assert torch.equal(got, want) and got_toks == want_toks


def test_which_kv_caches_bound_the_engines_positions():
    """Jamba's attention layers keep full caches of ``max_seq`` rows: they
    bound the positions at any ``max_seq``.  Mixtral's are window caches of
    ``min(max_seq, 4096)`` rows: shorter than the window they would wrap
    early (ROADMAP C.11), so they bound below 4096 and not from it on.
    The smoke run's serving traffic feeds at most 62 + 32 - 1 = 93 rows at
    ``max_seq`` 256, within both bounds."""
    mixtral, jamba = treg.load_config("mixtral-8x22b"), treg.load_config("jamba-v0.1-52b")
    assert teng._kv_cache_bounds_positions(jamba, 256)
    assert teng._kv_cache_bounds_positions(jamba, 8192)
    assert teng._kv_cache_bounds_positions(mixtral, 256)
    assert teng._kv_cache_bounds_positions(mixtral, 4095)
    assert not teng._kv_cache_bounds_positions(mixtral, 4096)
    # a pool whose decode call could drop an assignment is refused
    with pytest.raises(ValueError, match="dropless 512"):
        teng.ServeEngine(treg.bundle_from_cfg(mixtral, "cpu"), None, batch=257, max_seq=256)
    # refused only past max_seq
    tcfg = _cfgs("jamba-v0.1-52b")[1]
    eng = teng.ServeEngine(treg.bundle_from_cfg(tcfg, "cpu"), _params("jamba-v0.1-52b")[2],
                           batch=1, max_seq=16)
    eng.submit(teng.Request(rid=0, prompt=np.zeros(9, np.int32), max_new_tokens=8))
    with pytest.raises(ValueError, match="max_seq is 16"):
        eng.submit(teng.Request(rid=1, prompt=np.zeros(9, np.int32), max_new_tokens=9))


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def _jax_train(name, accum, optimizer, steps=3):
    jcfg, _ = _cfgs(name)
    bundle = jreg.bundle_from_cfg(jcfg)
    init_state, step = jtrain.make_train_step(
        bundle, JParallel(grad_accum=accum, remat="full"),
        JTrain(lr=1e-3, warmup=0, steps=steps, optimizer=optimizer))
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


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
@pytest.mark.parametrize("name,accum", [("mixtral-8x22b", 2), ("jamba-v0.1-52b", 1)])
def test_lm_train_step_matches_jax_trainer(name, accum, optimizer):
    """``tests/test_torch_lm.py``'s trainer case, with AdamW and with
    adafactor (every reduced leaf is narrower than adafactor's 128, so each
    keeps a full second moment).  Both optimizers divide by the root of a
    second moment, so an element whose gradient sits at rounding level
    (root below 1e-6) may take another step in either direction: such an
    element that misses PARAM_ATOL is held to tests/test_torch_lm.py's
    bound of 2 x 3 x lr x (1 + 0.1 |w|), and those are at most 0.5 % of all.
    (An expert sees a few of the tokens, so its leaves hold many gradients
    at rounding level, which mostly land within PARAM_ATOL all the same.)
    A leaf with a well-conditioned element past PARAM_ATOL is held by
    FP64_RULE against the port's fp64 trainer."""
    params0, want, jlosses = _jax_train(name, accum, optimizer)
    _, tcfg = _cfgs(name)

    def train(cfg, params):
        arch = treg.bundle_from_cfg(cfg, "cpu")
        init_state, step = make_train_step(
            arch, ParallelConfig(grad_accum=accum, remat="full"),
            TrainConfig(lr=1e-3, warmup=0, steps=3, optimizer=optimizer))
        state = init_state(0)._replace(params=params)
        specs = arch.input_specs(ShapeConfig("t", 16, 4, "train"))
        losses, vs = [], []
        for s in range(3):
            state, m = step(state, tsyn.place(tsyn.synth_batch(specs, cfg, 0, s), "cpu"))
            losses.append(float(m["loss"]))
            vs.append([v.clone() for v in tree_leaves(state.opt["v"])])
        return state.params, losses, vs

    params, losses, vs = train(tcfg, lm_params_from_jax(params0, "cpu"))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got, wanted = _named(params), _named(want)
    assert [n for n, _ in got] == [n for n, _ in wanted]
    decay = 0.95 if optimizer == "adamw" else 0.99
    exact = None
    n_ill = n_all = 0
    for i, ((n, p), (_, w)) in enumerate(zip(got, wanted)):
        ill = np.zeros(w.shape, bool)
        for t, v in enumerate(vs, start=1):
            root = np.sqrt(v[i].numpy() / (1 - decay ** t))
            ill |= (root > 0) & (root < ADAM_WELL_CONDITIONED)
        d = np.abs(p.numpy() - w)
        if np.any(d[~ill] >= PARAM_ATOL):
            # FP64_RULE on the leaf, against the port's fp64 trainer
            if exact is None:
                exact = dict(_named(train(_cfg64(tcfg),
                                          _fp64(lm_params_from_jax(params0, "cpu")))[0]))
            e = exact[n].numpy()
            assert _rms(w - e) <= PARAM_ATOL, (n, float(d[~ill].max()), _rms(w - e))
            assert _rms(p.numpy() - e) <= FP64_FACTOR * _rms(w - e), (n, float(d.max()))
        assert np.all(d[ill] <= 2 * 3 * 1e-3 * (1 + 0.1 * np.abs(w[ill]))), n
        n_ill += int((ill & (d >= PARAM_ATOL)).sum())
        n_all += ill.size
    assert n_ill <= ADAM_ILL_SHARE * n_all, (n_ill, n_all)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(IDS))
def test_launchers_run_each_id_on_cpu(name, capsys):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    layers = _cfgs(name)[1].n_layers
    assert train_main(["--arch", name, "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "32", "--optimizer", "adafactor"]) == 0
    out = capsys.readouterr().out
    assert f"model: {name} layers={layers}" in out and "optimizer=adafactor" in out
    assert "done: steps=2 restarts=0" in out
    assert serve_main(["--device", "cpu", "--arch", name, "--requests", "3", "--slots", "2",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
