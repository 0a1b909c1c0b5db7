"""DeepSeek-V3-671B (ROADMAP A.18.4: MLA, 3 dense layers then 256 routed
experts top-8 beside one shared expert, an MTP head) at its reduced config
(4 layers: one dense, three MoE; 8 experts top-2 and a shared one), fp32,
against the JAX package.

Params are initialised by JAX and handed over with ``lm_params_from_jax``;
every norm leaf (``q_norm`` and ``kv_norm`` too) gets the same seeded numpy
noise in both packages first.  On the CPU the RMSNorm op (B6) takes its
plain version; MLA runs the plain ``_sdpa``, as the reference's runs XLA.
- the config field by field, its segments and layer kinds, and the params
  leaf for leaf (``mtp.*`` and the shared expert included);
- ``apply_lm``, ``lm_loss`` with its MTP term (also apart: the main CE and
  0.3 x the MTP CE) and the grads of every leaf, remat ``none`` and
  ``full``, within ``tests/test_torch_lm.py``'s 1e-5 (FP64_RULE below where
  fp32 rounding parts the packages by more);
- ``decode_step``'s logits and ``MLACache`` leaves against JAX's decode;
  decode against the port's full forward at the reference's bar;
- ``ServeEngine``'s greedy answers against a greedy loop over the
  reference's ``apply_lm`` per prompt, and a request beside others giving
  the bits it gives alone; ``submit`` refusing past ``max_seq`` (the MLA
  caches bound the positions);
- 3 adafactor steps of the LM ``make_train_step`` against JAX's trainer;
- both launchers with the id on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v3_671b as jds
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.data import synthetic as jsyn
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.train import trainer as jtrain
from repro_torch.configs import deepseek_v3_671b as tds
from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.interop import lm_caches_from_jax, lm_params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.models.attention import MLACache
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serve import engine as teng
from repro_torch.train.trainer import lm_value_and_grad, make_train_step

NAME = "deepseek-v3-671b"
ATOL = 1e-5                                  # tests/test_torch_lm.py
PARAM_ATOL = 1e-5
# FP64_RULE (tests/test_torch_moe_configs.py): a tensor that misses ATOL is
# held instead against an fp64 evaluation of the port on the same inputs:
# JAX's within NORM_RTOL of the largest entry, and the port's RMS distance
# from it no more than FP64_FACTOR x JAX's.
NORM_RTOL = 1e-4
FP64_FACTOR = 2.0
ADAM_WELL_CONDITIONED = 1e-6                 # tests/test_torch_moe_configs.py
ADAM_ILL_SHARE = 5e-3
DECODE_BAR = dict(atol=2e-2, rtol=2e-2)      # tests/test_attention.py:94-96
REF_LEN = 64                                 # the greedy reference's padded length
JCFG, TCFG = jds.reduced(), tds.reduced()


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


def _params():
    """(JAX params, the same as numpy, the port's) of the reduced config,
    seed 0, perturbed."""
    if not _PARAMS:
        npp = _perturbed(jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(0), JCFG)))
        _PARAMS["p"] = (jax.tree.map(jnp.asarray, npp), npp, lm_params_from_jax(npp, "cpu"))
    return _PARAMS["p"]


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


# ---------------------------------------------------------------------------
# config and params
# ---------------------------------------------------------------------------


def test_config_matches_the_reference():
    assert treg.load_config(NAME) == tds.CONFIG
    assert treg.load_config(NAME, reduced=True) == tds.reduced()
    assert NAME not in treg.ROADMAP_ITEMS
    for jc, tc in ((jds.CONFIG, tds.CONFIG), (jds.reduced(), tds.reduced())):
        for f in dataclasses.fields(jc):
            want, got = getattr(jc, f.name), getattr(tc, f.name)
            if dataclasses.is_dataclass(want):
                assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
            else:
                assert got == want, f.name
        assert [dataclasses.astuple(s) for s in tlm.plan_segments(tc)] == \
            [dataclasses.astuple(s) for s in jlm.plan_segments(jc)]
        assert [dataclasses.astuple(tlm.layer_kind(tc, i)) for i in range(tc.n_layers)] == \
            [dataclasses.astuple(jlm.layer_kind(jc, i)) for i in range(jc.n_layers)]
    kinds = [tlm.layer_kind(tds.CONFIG, i) for i in range(61)]
    assert [i for i, k in enumerate(kinds) if not k.moe] == [0, 1, 2]
    assert all(k.mixer == "attn" and not k.swa for k in kinds)
    # the smoke run's cuts: 3 layers (all dense; the MTP layer dense too), 4 (one MoE)
    cut = treg.with_depth(tds.CONFIG, 0)
    assert cut.n_layers == 3 and not tlm.layer_kind(cut, cut.n_layers - 1).moe
    assert tlm.layer_kind(treg.with_depth(tds.CONFIG, 1), 3).moe


def test_params_convert_leaf_for_leaf():
    _, npp, tp = _params()
    got, want = _named(tp), _named(npp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, n
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    names = [n for n, _ in got]
    assert {"/mtp/proj", "/mtp/norm/scale"} <= set(names)
    assert any(n.startswith("/mtp/layer/moe/shared/") for n in names)
    assert any(n.startswith("/segments/1/0/moe/shared/") for n in names)
    assert tp["mtp"]["proj"].shape == (2 * TCFG.d_model, TCFG.d_model)
    # the port's own init draws the same tree (keys, shapes, dtypes); in bf16
    # every leaf but the routers is bf16
    own = treg.bundle_from_cfg(TCFG, "cpu").init(0)
    assert [(n, tuple(a.shape), a.dtype) for n, a in _named(own)] == \
        [(n, tuple(a.shape), a.dtype) for n, a in got]
    bf16 = dataclasses.replace(TCFG, dtype="bfloat16", param_dtype="bfloat16")
    for n, a in _named(treg.bundle_from_cfg(bf16, "cpu").init(0)):
        assert a.dtype == (torch.float32 if n.endswith("router") else torch.bfloat16), n


def test_init_draws_the_mtp_head_last_and_serving_keeps_it():
    """The MTP head is drawn after the segments: the same seed gives the
    same segments with or without it."""
    with_mtp = treg.bundle_from_cfg(TCFG, "cpu").init(0)
    without = treg.bundle_from_cfg(dataclasses.replace(TCFG, mtp_depth=0), "cpu").init(0)
    assert "mtp" not in without
    for (n, a), (m, b) in zip(_named(without), _named({k: v for k, v in with_mtp.items()
                                                       if k != "mtp"})):
        assert n == m and torch.equal(a, b), n


# ---------------------------------------------------------------------------
# forward, loss and grads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full"])
def test_apply_lm_loss_and_grads_match_jax(remat):
    """Two sequences of 32 tokens: 128 assignments, the dropless floor.
    The loss holds the MTP term; every leaf's gradient, ``mtp.*`` and the
    shared experts' included."""
    jp, _, tp = _params()
    batch = _batch(JCFG.vocab)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jlm.apply_lm(jp, jb["tokens"], JCFG, remat=remat))
    got = tlm.apply_lm(tp, tb["tokens"], TCFG, remat=remat)
    exact = tlm.apply_lm(_fp64(tp), tb["tokens"], _cfg64(TCFG), remat=remat)
    _close(got.detach().numpy(), want, exact.detach().numpy(), "apply_lm")
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jb, JCFG, remat=remat, ce_chunk=20)))(jp)
    tl, tg = lm_value_and_grad(
        lambda p, bt: tlm.lm_loss(p, bt, TCFG, remat=remat, ce_chunk=20), tp, tb)
    _, g64 = lm_value_and_grad(
        lambda p, bt: tlm.lm_loss(p, bt, _cfg64(TCFG), remat=remat, ce_chunk=20), _fp64(tp), tb)
    assert abs(float(tl) - float(jl)) <= ATOL * max(1.0, abs(float(jl)))
    got, want, exact = _named(tg), _named(jax.tree.map(np.asarray, jg)), _named(g64)
    assert [n for n, _ in got] == [n for n, _ in want] == [n for n, _ in exact]
    assert any(n.startswith("/mtp/layer/") for n, _ in got)
    for (n, a), (_, w), (_, e) in zip(got, want, exact):
        assert float(a.abs().max()) > 0, n
        _close(a.numpy(), w, e.numpy(), n)


def test_the_mtp_term_apart_matches_jax():
    """The main CE (the loss without ``mtp`` in the params, in both
    packages) and 0.3 x the MTP CE, reported apart: each against JAX's,
    and the sum is the loss."""
    jp, _, tp = _params()
    batch = _batch(JCFG.vocab, seed=5)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    no_mtp = {k: v for k, v in jp.items() if k != "mtp"}
    j_main = float(jlm.lm_loss(no_mtp, jb, JCFG))
    j_all = float(jlm.lm_loss(jp, jb, JCFG))
    t_main = float(tlm.lm_loss({k: v for k, v in tp.items() if k != "mtp"}, tb, TCFG))
    hidden = tlm.apply_lm(tp, tb["tokens"], TCFG)
    t_mtp = float(tlm.mtp_loss(tp, tb, hidden, tlm.lm_head_weight(tp, TCFG), TCFG))
    t_all = float(tlm.lm_loss(tp, tb, TCFG))
    assert tlm.MTP_WEIGHT == 0.3
    assert abs(t_main - j_main) <= ATOL * j_main
    assert abs(tlm.MTP_WEIGHT * t_mtp - (j_all - j_main)) <= ATOL * j_all
    assert t_all == pytest.approx(t_main + tlm.MTP_WEIGHT * t_mtp, rel=1e-6)
    assert t_mtp > 1.0          # a CE of a random model: log(256) ~ 5.5


def test_mtp_normalises_after_the_projection_as_the_reference():
    """A standing fact (ROADMAP C): arXiv:2412.19437 §2.2 normalises the two
    MTP inputs before the projection, h' = M [RMSNorm(h); RMSNorm(Emb(t+1))];
    the reference projects the final-normed hidden state beside the raw
    embedding and normalises after, RMSNorm(M [h; Emb(t+1)])
    (``repro/models/lm.py:321-330``).  The port mirrors the reference: its
    MTP input equals the reference's order, and the paper's order gives
    another one."""
    from repro_torch.models.common import rms_norm

    _, _, tp = _params()
    batch = _batch(JCFG.vocab, seed=6)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    hidden = tlm.apply_lm(tp, tb["tokens"], TCFG)
    emb = torch.nn.functional.embedding(torch.roll(tb["tokens"], -1, 1).long(), tp["embed"])
    mtp = tp["mtp"]
    seen = []
    real = tlm._apply_layer

    def spy(p, kind, x, *a, **k):
        if p is mtp["layer"]:
            seen.append(x)
        return real(p, kind, x, *a, **k)

    tlm._apply_layer = spy
    try:
        tlm.mtp_loss(tp, tb, hidden, tlm.lm_head_weight(tp, TCFG), TCFG)
    finally:
        tlm._apply_layer = real
    ref_order = rms_norm(torch.cat([hidden, emb], -1) @ mtp["proj"], mtp["norm"]["scale"])
    ones = torch.ones(TCFG.d_model)
    paper_order = torch.cat([rms_norm(hidden, ones), rms_norm(emb, ones)], -1) @ mtp["proj"]
    assert len(seen) == 1 and torch.equal(seen[0], ref_order)
    assert float((paper_order - ref_order).abs().max()) > 0.1


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def test_decode_step_and_caches_match_jax():
    """As ``tests/test_torch_moe_configs.py``: two slots after 7 decoded
    tokens, set to lengths 3 and 7, then 12 steps (slot 1 runs past the
    24-row cache's last row at step 17)."""
    jp, _, tp = _params()
    rng = np.random.default_rng(1)
    dec = jax.jit(lambda c, t: jlm.decode_step(jp, t, c, JCFG))
    jc = jlm.init_caches(JCFG, 2, 24, JCFG.act_dtype)
    for _ in range(7):
        _, jc = dec(jc, jnp.asarray(rng.integers(0, JCFG.vocab, (2, 1), dtype=np.int32)))
    jc = [c._replace(lengths=jnp.asarray([3, 7], jnp.int32)) for c in jc]
    tc = lm_caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert all(isinstance(c, MLACache) for c in tc)
    tc64 = [MLACache(*(t.double() if t.is_floating_point() else t.clone() for t in c))
            for c in tc]
    tp64, cfg64 = _fp64(tp), _cfg64(TCFG)
    for step in range(12):
        tok = rng.integers(0, JCFG.vocab, (2, 1), dtype=np.int32)
        jl, jc = dec(jc, jnp.asarray(tok))
        tl, _ = tlm.decode_step(tp, torch.from_numpy(tok), tc, TCFG)
        tl64, _ = tlm.decode_step(tp64, torch.from_numpy(tok), tc64, cfg64)
        assert tl.dtype == torch.float32 and tl.shape == (2, 1, TCFG.vocab)
        _close(tl.numpy(), np.asarray(jl), tl64.numpy(), f"logits, step {step}")
        leaves = zip(jax.tree.leaves(jc), [t for c in tc for t in c], [t for c in tc64 for t in c])
        for i, (a, b, e) in enumerate(leaves):
            _close(b.numpy(), np.asarray(a), e.numpy(), f"cache leaf {i}, step {step}")
    assert [c.lengths.tolist() for c in tc] == [[15, 19]] * TCFG.n_layers


def test_caches_and_specs():
    arch = treg.bundle_from_cfg(TCFG, "cpu")
    got, spec = arch.make_caches(3, 12), arch.cache_specs(3, 12)
    want = jlm.init_caches(JCFG, 3, 12, JCFG.act_dtype)
    assert len(got) == len(spec) == len(want) == TCFG.n_layers
    for g, s, w in zip(got, spec, want):
        assert type(w).__name__ == "MLACache" and isinstance(g, MLACache)
        assert isinstance(s, MLACache) and g._fields == w._fields
        for gt, st, wt in zip(g, s, w):
            wt = np.asarray(wt)
            assert tuple(gt.shape) == tuple(st.shape) == wt.shape
            assert gt.dtype == st.dtype == getattr(torch, str(wt.dtype))
            assert st.device.type == "meta" and not bool(gt.any())


def test_decode_matches_the_full_forward():
    """One sequence of 48 tokens: 96 assignments, so the forward, like
    every decode, is dropless; the decode is the absorbed form, the forward
    is not."""
    _, _, tp = _params()
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, TCFG.vocab, (1, 48),
                                                                 dtype=np.int32))
    full = (tlm.apply_lm(tp, tokens, TCFG) @ tlm.lm_head_weight(tp, TCFG).T).float()
    caches = treg.bundle_from_cfg(TCFG, "cpu").make_caches(1, 48)
    outs = [tlm.decode_step(tp, tokens[:, t:t + 1], caches, TCFG)[0][:, 0] for t in range(48)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), **DECODE_BAR)


def test_engine_greedy_answers_equal_the_reference_forward_per_prompt():
    """5 requests over 2 slots, unequal prompt and answer lengths, so slots
    recycle: each answer is the greedy continuation of its prompt alone by
    the reference's full forward (at REF_LEN tokens, dropless)."""
    jp, _, tp = _params()
    eng = teng.ServeEngine(treg.bundle_from_cfg(TCFG, "cpu"), tp, batch=2, max_seq=32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, JCFG.vocab, size=int(rng.integers(3, 10))).astype(np.int32)
               for _ in range(5)]
    news = [5, 3, 6, 2, 4]
    for rid, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=n))
    done = eng.run(max_ticks=200)
    assert sorted(r.rid for r in done) == list(range(5))

    @jax.jit
    def logits_at(tokens):
        hidden = jlm.apply_lm(jp, tokens, JCFG)
        return (hidden[0] @ jlm.lm_head_weight(jp, JCFG).T).astype(jnp.float32)

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


def test_a_request_beside_others_gives_its_bits_alone():
    """A request admitted into a recycled slot beside two others gives the
    logits and tokens it gives alone, bit for bit: the slots' compressed
    caches are written row by row, and a decode call of 3 slots dispatches
    6 assignments (dropless)."""
    _, _, tp = _params()
    arch = treg.bundle_from_cfg(TCFG, "cpu")
    rng = np.random.default_rng(19)
    p = [rng.integers(0, TCFG.vocab, size=n).astype(np.int32) for n in (5, 9, 7, 11)]
    got, got_toks = _served(arch, tp, [(0, p[0], 3), (1, p[1], 12), (2, p[2], 12),
                                       (3, p[3], 8)], 3)
    want, want_toks = _served(arch, tp, [(3, p[3], 8)], 3)
    assert got.shape == want.shape == (8, TCFG.vocab)
    assert torch.equal(got, want) and got_toks == want_toks


def test_submit_refuses_past_max_seq_on_mla_caches():
    """An MLA layer's compressed cache is a full cache of ``max_seq`` rows,
    so it bounds the positions at any ``max_seq``: the engine refuses a
    request that would feed past it (the reference would write those
    positions into the last row, ROADMAP C.10).  The full config's
    4 slots x top-8 = 32 assignments a decode call stay dropless."""
    assert teng._kv_cache_bounds_positions(tds.CONFIG, 256)
    assert teng._kv_cache_bounds_positions(TCFG, 8192)
    arch = treg.bundle_from_cfg(TCFG, "cpu")
    eng = teng.ServeEngine(arch, _params()[2], batch=1, max_seq=16)
    eng.submit(teng.Request(rid=0, prompt=np.zeros(9, np.int32), max_new_tokens=8))
    with pytest.raises(ValueError, match="max_seq is 16"):
        eng.submit(teng.Request(rid=1, prompt=np.zeros(9, np.int32), max_new_tokens=9))
    assert 4 * tds.CONFIG.moe.top_k <= teng.DROPLESS_ASSIGNMENTS < 65 * tds.CONFIG.moe.top_k
    with pytest.raises(ValueError, match="dropless 512"):
        teng.ServeEngine(treg.bundle_from_cfg(tds.CONFIG, "cpu"), None, batch=65, max_seq=8)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_lm_train_step_matches_jax_trainer():
    """3 adafactor steps, 2 microbatches, against JAX's trainer:
    ``tests/test_torch_moe_configs.py``'s trainer case and bars (an element
    whose second moment's root sits below 1e-6 may step either way: held
    to 2 x 3 x lr x (1 + 0.1 |w|), at most 0.5 % of all)."""
    steps, accum = 3, 2
    bundle = jreg.bundle_from_cfg(JCFG)
    init_state, jstep = jtrain.make_train_step(
        bundle, JParallel(grad_accum=accum, remat="full"),
        JTrain(lr=1e-3, warmup=0, steps=steps, optimizer="adafactor"))
    state = init_state(jax.random.PRNGKey(0))
    params0 = _perturbed(jax.tree.map(np.asarray, state.params))
    state = state._replace(params=jax.tree.map(jnp.asarray, params0))
    specs = bundle.input_specs(JShape("t", 16, 4, "train"))
    jstep = jax.jit(jstep)
    jlosses = []
    for s in range(steps):
        state, m = jstep(state, jsyn.synth_batch(specs, JCFG, 0, s))
        jlosses.append(float(m["loss"]))
    want = jax.tree.map(np.asarray, state.params)

    def train(cfg, params):
        arch = treg.bundle_from_cfg(cfg, "cpu")
        init_state, step = make_train_step(
            arch, ParallelConfig(grad_accum=accum, remat="full"),
            TrainConfig(lr=1e-3, warmup=0, steps=steps, optimizer="adafactor"))
        st = init_state(0)._replace(params=params)
        specs = arch.input_specs(ShapeConfig("t", 16, 4, "train"))
        losses, vs = [], []
        for s in range(steps):
            st, m = step(st, tsyn.place(tsyn.synth_batch(specs, cfg, 0, s), "cpu"))
            losses.append(float(m["loss"]))
            vs.append([v.clone() for v in tree_leaves(st.opt["v"])])
        return st.params, losses, vs

    params, losses, vs = train(TCFG, lm_params_from_jax(params0, "cpu"))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got, wanted = _named(params), _named(want)
    assert [n for n, _ in got] == [n for n, _ in wanted]
    exact = None
    n_ill = n_all = 0
    for i, ((n, p), (_, w)) in enumerate(zip(got, wanted)):
        ill = np.zeros(w.shape, bool)
        for t, v in enumerate(vs, start=1):
            root = np.sqrt(v[i].numpy() / (1 - 0.99 ** t))
            ill |= (root > 0) & (root < ADAM_WELL_CONDITIONED)
        d = np.abs(p.numpy() - w)
        if np.any(d[~ill] >= PARAM_ATOL):
            if exact is None:
                exact = dict(_named(train(_cfg64(TCFG),
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


def test_launchers_run_the_id_on_cpu(capsys):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    assert train_main(["--arch", NAME, "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "32", "--optimizer", "adafactor"]) == 0
    out = capsys.readouterr().out
    assert f"model: {NAME} layers=4" in out and "optimizer=adafactor" in out
    assert "done: steps=2 restarts=0" in out
    assert serve_main(["--device", "cpu", "--arch", NAME, "--requests", "3", "--slots", "2",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
