"""Qwen2-VL-2B (ROADMAP A.18.5: M-RoPE, patch embeddings in place of the
leading tokens) at its reduced config (2 layers, d_model 64, 4 heads of 16
over 2 KV heads, sections (4, 2, 2)), fp32, against the JAX package.

Params are initialised by JAX and handed over with ``lm_params_from_jax``;
every norm and bias leaf gets the same seeded numpy noise in both packages
first.  On the CPU the flash-attention (B4) and RMSNorm (B6) ops take their
plain versions, and JAX's ``_sdpa`` its naive mode (fewer than 2048 keys).
- ``apply_mrope`` at three distinct streams, fp32 and bf16, and equal to
  plain RoPE bit for bit at equal streams;
- M-RoPE attention against the reference's own ``_qkv`` / ``_rope_qk`` /
  ``_sdpa`` with a mask by the sequence index, and ROADMAP C.14 with both
  halves: the reference's hidden state at position 2 moves under a change to
  token 4 on the streams below, the port's does not, and the port's
  ``apply_lm`` equals the reference's with ``_sdpa`` masked by the index;
- ``apply_lm``, ``lm_loss`` and every grad leaf on the reference's own
  inputs (``synth_batch``: patch embeddings and three ``arange`` streams),
  remat ``none`` and ``full``, within 1e-5 (FP64_RULE where fp32 rounding
  parts the packages by more);
- ``decode_step`` and its caches against JAX's decode (the three streams
  broadcast from each slot's length), and against the port's full forward;
- the registry's specs, ``synth_batch``'s bits (fp32 patch embeddings bit
  for bit; bf16 ones against ``ml_dtypes``' cast, which rounds float64 ->
  bfloat16 through float32, as torch does), the engine's greedy answers
  against the reference's forward per prompt, 3 AdamW steps with
  ``grad_accum`` 2 against JAX's trainer, and both launchers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import qwen2_vl_2b as jvl
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.data import synthetic as jsyn
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.train import trainer as jtrain
from repro_torch.configs import qwen2_vl_2b as tvl
from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.interop import lm_caches_from_jax, lm_params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serve import engine as teng
from repro_torch.train.trainer import lm_value_and_grad, make_train_step

NAME = "qwen2-vl-2b"
ATOL = 1e-5                                  # tests/test_torch_lm.py
PARAM_ATOL = 1e-5
# FP64_RULE (tests/test_torch_moe_configs.py): a tensor that misses ATOL is
# held instead against an fp64 evaluation of the port on the same inputs:
# JAX's within NORM_RTOL of the largest entry, and the port's RMS distance
# from it no more than FP64_FACTOR x JAX's.
NORM_RTOL = 1e-4
FP64_FACTOR = 2.0
ADAM_WELL_CONDITIONED = 1e-6                 # tests/test_torch_lm.py
ADAM_ILL_SHARE = 5e-3
DECODE_BAR = dict(atol=2e-2, rtol=2e-2)      # tests/test_attention.py:94-96
REF_LEN = 32                                 # the greedy reference's padded length
JCFG, TCFG = jvl.reduced(), tvl.reduced()
# C.14's streams: tokens 2-5 are one image's 2 x 2 patches (one temporal
# position, their own height and width), then text again
STREAMS = np.array([[0, 1, 2, 2, 2, 2, 4, 5],      # temporal
                    [0, 1, 2, 2, 3, 3, 4, 5],      # height
                    [0, 1, 2, 3, 2, 3, 4, 5]],     # width
                   np.int32)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _perturbed(tree):
    """Every norm and bias leaf plus seeded noise, the rest as given."""
    rng = np.random.default_rng(11)

    def leaf(path, a):
        key = jax.tree_util.keystr(path)
        if "norm" in key or "'b_" in key:
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


def _ref_batch(seq=16, batch=4, seed=0, step=0):
    """The reference's own batch: its specs, its ``synth_batch``."""
    specs = jreg.bundle_from_cfg(JCFG).input_specs(JShape("t", seq, batch, "train"))
    return jsyn.synth_batch(specs, JCFG, seed, step)


def _distinct_streams(b, t, seed):
    """(3, B, T) streams that differ from each other and from the index."""
    rng = np.random.default_rng(seed)
    return np.stack([np.sort(rng.integers(0, t + 5, (b, t)), axis=-1) for _ in range(3)]
                    ).astype(np.int32)


# ---------------------------------------------------------------------------
# config, specs, batches, params
# ---------------------------------------------------------------------------


def test_config_specs_and_registry_match_the_reference():
    assert treg.load_config(NAME) == tvl.CONFIG and treg.load_config(NAME, reduced=True) == TCFG
    for jc, tc in ((jvl.CONFIG, tvl.CONFIG), (JCFG, TCFG)):
        for f in dataclasses.fields(jc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert [dataclasses.astuple(s) for s in tlm.plan_segments(tc)] == \
            [dataclasses.astuple(s) for s in jlm.plan_segments(jc)]
    assert tvl.CONFIG.resolved_head_dim == 128 and sum(tvl.CONFIG.mrope_sections) == 64
    # every reference id resolves, none is left to a ROADMAP item
    assert treg.ARCH_IDS == jreg.ARCH_IDS and treg.ROADMAP_ITEMS == {}
    for name in jreg.ARCH_IDS:
        assert treg.load_config(name).name == jreg.load_config(name).name
    for seq, batch in ((16, 4), (64, 2), (8, 1)):
        want = jreg.bundle_from_cfg(JCFG).input_specs(JShape("t", seq, batch, "train"))
        got = treg.bundle_from_cfg(TCFG, "cpu").input_specs(ShapeConfig("t", seq, batch, "train"))
        assert list(got) == list(want) == ["tokens", "labels", "patch_embeds", "positions"]
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert str(got[k].dtype).replace("torch.", "") == str(np.dtype(want[k].dtype)), k
        assert treg._vision_tokens(seq) == jreg._vision_tokens(seq) == max(4, seq // 4)
    decode = treg.bundle_from_cfg(TCFG, "cpu").input_specs(ShapeConfig("d", 8, 3, "decode"))
    assert {k: tuple(s.shape) for k, s in decode.items()} == {"token": (3, 1)}


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 2)])
def test_synth_batch_draws_the_reference_bits(seed, step):
    """fp32 patch embeddings bit for bit; bf16 ones as ``ml_dtypes`` casts
    the reference's float64 draw.  Both round float64 -> bfloat16 through
    float32 (two roundings): 1 + 2^-8 + 2^-30 goes to 1.0 in both, where a
    single rounding would give 1 + 2^-7."""
    shape = ShapeConfig("t", 32, 4, "train")
    want = jsyn.synth_batch(jreg.bundle_from_cfg(JCFG).input_specs(JShape("t", 32, 4, "train")),
                            JCFG, seed, step)
    got = tsyn.synth_batch(treg.bundle_from_cfg(TCFG, "cpu").input_specs(shape), TCFG, seed, step)
    assert set(got) == set(want)
    for k in ("tokens", "labels", "positions"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert got["patch_embeds"].dtype == torch.float32
    np.testing.assert_array_equal(got["patch_embeds"].numpy(), want["patch_embeds"])
    bf = dataclasses.replace(TCFG, dtype="bfloat16", param_dtype="bfloat16")
    jbf = dataclasses.replace(JCFG, dtype="bfloat16", param_dtype="bfloat16")
    wb = jsyn.synth_batch(jreg.bundle_from_cfg(jbf).input_specs(JShape("t", 32, 4, "train")),
                          jbf, seed, step)["patch_embeds"]
    gb = tsyn.synth_batch(treg.bundle_from_cfg(bf, "cpu").input_specs(shape), bf, seed,
                          step)["patch_embeds"]
    assert wb.dtype == ml_dtypes.bfloat16 and gb.dtype == torch.bfloat16
    np.testing.assert_array_equal(gb.view(torch.int16).numpy(), wb.view(np.int16))
    half = np.array([1 + 2 ** -8 + 2 ** -30, 1 + 2 ** -8, -(1 + 3 * 2 ** -8)], np.float64)
    assert half.astype(ml_dtypes.bfloat16).astype(np.float64).tolist() == \
        torch.from_numpy(half).to(torch.bfloat16).double().tolist() == [1.0, 1.0, -1.015625]
    placed = tsyn.place(got, "cpu")
    assert placed["positions"].shape == (3, 4, 32) and placed["patch_embeds"] is not None


def test_params_convert_leaf_for_leaf():
    _, npp, tp = _params()
    got, want = _named(tp), _named(npp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, n
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    assert "lm_head" not in tp          # tied embeddings
    own = treg.bundle_from_cfg(TCFG, "cpu").init(0)
    assert [(n, tuple(a.shape), a.dtype) for n, a in _named(own)] == \
        [(n, tuple(a.shape), a.dtype) for n, a in got]


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_jax_at_distinct_streams(dtype):
    """Full width's head dim and sections (128, (16, 24, 24)) and the
    reduced config's (16, (4, 2, 2)); fp32 angles in both packages."""
    rng = np.random.default_rng(2)
    for dh, sections in ((128, (16, 24, 24)), (16, (4, 2, 2))):
        x = rng.standard_normal((2, 12, 3, dh)).astype(np.float32)
        pos = _distinct_streams(2, 12, 4)
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        want = np.asarray(jcommon.apply_mrope(jx, jnp.asarray(pos), 1e6, sections)
                          .astype(jnp.float32))
        tx = torch.from_numpy(x).to(getattr(torch, dtype))
        got = tcommon.apply_mrope(tx, torch.from_numpy(pos), 1e6, sections)
        assert got.dtype == tx.dtype and got.shape == tx.shape
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
        else:
            # one bf16 rounding of the same fp32 value, or one ulp apart where
            # the fp32 angles' cos/sin differ in their last bit
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
            assert np.all(np.abs(got.float().numpy() - want) <= ulp), dh
        # the three streams are distinct: a stream's own slots see it
        for si in range(3):
            moved = pos.copy()
            moved[si] += 3
            other = tcommon.apply_mrope(tx, torch.from_numpy(moved), 1e6, sections)
            assert not torch.equal(other, got), si
    with pytest.raises(ValueError, match="sections"):
        tcommon.apply_mrope(tx, torch.from_numpy(pos), 1e6, (4, 2, 1))


def test_mrope_at_equal_streams_is_plain_rope_bit_for_bit():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 9, 4, 128)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 50, (2, 9)))
    got = tcommon.apply_mrope(x, pos.expand(3, 2, 9), 1e6, (16, 24, 24))
    assert torch.equal(got, tcommon.apply_rope(x, pos, 1e6))


def _jax_attention_index_mask(jp_attn, x, positions):
    """The reference's own ``_qkv`` / ``_rope_qk`` / ``_sdpa`` with the
    causal mask by the sequence index (``attention`` without C.14)."""
    q, k, v = jattn._qkv(jp_attn, x, JCFG)
    q, k = jattn._rope_qk(q, k, positions, JCFG)
    idx = jnp.arange(x.shape[1], dtype=jnp.int32)[None]
    out = jattn._sdpa(q, k, v, idx, idx, causal=True, window=None)
    return jnp.einsum("bthe,hed->btd", out, jp_attn["w_o"])


def test_mrope_attention_is_the_reference_with_an_index_mask():
    jp, _, tp = _params()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 10, TCFG.d_model)).astype(np.float32)
    pos = _distinct_streams(2, 10, 5)
    ja = jax.tree.map(lambda a: a[0], jp["segments"][0][0]["attn"])
    ta = jax.tree.map(lambda a: a[0], tp["segments"][0][0]["attn"])
    want = np.asarray(_jax_attention_index_mask(ja, jnp.asarray(x), jnp.asarray(pos)))
    got = tattn.attention(ta, torch.from_numpy(x), torch.from_numpy(pos), TCFG)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # where the temporal stream is the index, the reference's own attention agrees
    idx = np.broadcast_to(np.arange(10, dtype=np.int32), (3, 2, 10)).copy()
    idx[1:] = pos[1:]
    np.testing.assert_allclose(
        tattn.attention(ta, torch.from_numpy(x), torch.from_numpy(idx), TCFG).numpy(),
        np.asarray(jattn.attention(ja, jnp.asarray(x), jnp.asarray(idx), JCFG)), atol=ATOL)


def _index_masked_sdpa(q, k, v, qpos, kpos, *, causal, window, **kw):
    idx = jnp.arange(q.shape[1], dtype=jnp.int32)[None]
    return _REAL_SDPA(q, k, v, idx, jnp.arange(k.shape[1], dtype=jnp.int32)[None],
                      causal=causal, window=window, **kw)


_REAL_SDPA = jattn._sdpa


def test_c14_the_reference_masks_by_the_temporal_stream_the_port_by_the_index(monkeypatch):
    """ROADMAP C.14.  On STREAMS (one image of 2 x 2 patches at tokens
    2-5), a change to token 4 moves the reference's hidden state at
    position 2, which a causal LM must not see; it leaves the port's as it
    was.  The port equals the reference with ``_sdpa`` masked by the
    index."""
    jp, _, tp = _params()
    rng = np.random.default_rng(14)
    tokens = rng.integers(0, JCFG.vocab, (1, 8), dtype=np.int32)
    other = tokens.copy()
    other[0, 4] = (tokens[0, 4] + 17) % JCFG.vocab
    pos = STREAMS[:, None, :]

    def jax_hidden(toks):
        return np.asarray(jlm.apply_lm(jp, jnp.asarray(toks), JCFG, positions=jnp.asarray(pos)))

    def port_hidden(toks):
        return tlm.apply_lm(tp, torch.from_numpy(toks), TCFG,
                            positions=torch.from_numpy(pos)).numpy()

    ref_move = float(np.abs(jax_hidden(tokens)[0, 2] - jax_hidden(other)[0, 2]).max())
    assert ref_move > 0.1, ref_move
    assert np.array_equal(port_hidden(tokens)[0, :4], port_hidden(other)[0, :4])
    monkeypatch.setattr(jattn, "_sdpa", _index_masked_sdpa)
    for toks in (tokens, other):
        np.testing.assert_allclose(port_hidden(toks), jax_hidden(toks), atol=ATOL)


# ---------------------------------------------------------------------------
# forward, loss and grads on the reference's own inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", ["none", "full"])
def test_apply_lm_loss_and_grads_match_jax(remat):
    """The reference's ``synth_batch``: 4 patch embeddings of 16 tokens and
    three ``arange`` streams; the patches replace the leading tokens."""
    jp, _, tp = _params()
    batch = _ref_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = tsyn.place(batch, "cpu")
    want = np.asarray(jlm.apply_lm(jp, jb["tokens"], JCFG, positions=jb["positions"],
                                   extra_embeds=jb["patch_embeds"], remat=remat))
    got = tlm.apply_lm(tp, tb["tokens"], TCFG, positions=tb["positions"],
                       extra_embeds=tb["patch_embeds"], remat=remat)
    exact = tlm.apply_lm(_fp64(tp), tb["tokens"], _cfg64(TCFG), positions=tb["positions"],
                         extra_embeds=tb["patch_embeds"], remat=remat)
    _close(got.detach().numpy(), want, exact.detach().numpy(), "apply_lm")
    # the patches matter, and the default positions are the three arange streams
    no_patch = tlm.apply_lm(tp, tb["tokens"], TCFG)
    assert float((no_patch - got).abs().max()) > 0.1
    assert torch.equal(tlm.apply_lm(tp, tb["tokens"], TCFG, extra_embeds=tb["patch_embeds"]), got)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jb, JCFG, remat=remat, ce_chunk=20)))(jp)
    tl, tg = lm_value_and_grad(
        lambda p, bt: tlm.lm_loss(p, bt, TCFG, remat=remat, ce_chunk=20), tp, tb)
    _, g64 = lm_value_and_grad(
        lambda p, bt: tlm.lm_loss(p, bt, _cfg64(TCFG), remat=remat, ce_chunk=20), _fp64(tp), tb)
    assert abs(float(tl) - float(jl)) <= ATOL * max(1.0, abs(float(jl)))
    got, want, exact = _named(tg), _named(jax.tree.map(np.asarray, jg)), _named(g64)
    assert [n for n, _ in got] == [n for n, _ in want] == [n for n, _ in exact]
    for (n, a), (_, w), (_, e) in zip(got, want, exact):
        assert float(a.abs().max()) > 0, n
        _close(a.numpy(), w, e.numpy(), n)


# ---------------------------------------------------------------------------
# decode and serving
# ---------------------------------------------------------------------------


def test_decode_step_and_caches_match_jax():
    """Two slots after 5 decoded tokens, set to lengths 2 and 5, then 8
    steps: the three streams are each slot's length."""
    jp, _, tp = _params()
    rng = np.random.default_rng(1)
    dec = jax.jit(lambda c, t: jlm.decode_step(jp, t, c, JCFG))
    jc = jlm.init_caches(JCFG, 2, 16, JCFG.act_dtype)
    for _ in range(5):
        _, jc = dec(jc, jnp.asarray(rng.integers(0, JCFG.vocab, (2, 1), dtype=np.int32)))
    jc = [c._replace(lengths=jnp.asarray([2, 5], jnp.int32)) for c in jc]
    tc = lm_caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    for step in range(8):
        tok = rng.integers(0, JCFG.vocab, (2, 1), dtype=np.int32)
        jl, jc = dec(jc, jnp.asarray(tok))
        tl, _ = tlm.decode_step(tp, torch.from_numpy(tok), tc, TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=str(step))
        for a, b in zip(jax.tree.leaves(jc), [t for c in tc for t in c]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
    assert [c.lengths.tolist() for c in tc] == [[10, 13]] * TCFG.n_layers


def test_decode_matches_the_full_forward():
    _, _, tp = _params()
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, TCFG.vocab, (2, 24),
                                                                 dtype=np.int32))
    full = (tlm.apply_lm(tp, tokens, TCFG) @ tlm.lm_head_weight(tp, TCFG).T).float()
    caches = treg.bundle_from_cfg(TCFG, "cpu").make_caches(2, 24)
    outs = [tlm.decode_step(tp, tokens[:, t:t + 1], caches, TCFG)[0][:, 0] for t in range(24)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), **DECODE_BAR)


def test_engine_greedy_answers_equal_the_reference_forward_per_prompt():
    """5 token prompts over 2 slots (the reference's engine serves text
    alone too): each answer is the greedy continuation of its prompt by the
    reference's full forward at its default positions."""
    jp, _, tp = _params()
    eng = teng.ServeEngine(treg.bundle_from_cfg(TCFG, "cpu"), tp, batch=2, max_seq=24)
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


# ---------------------------------------------------------------------------
# the trainer and the launchers
# ---------------------------------------------------------------------------


def test_lm_train_step_matches_jax_trainer():
    """3 AdamW steps, 2 microbatches (the positions split on their batch
    dim), on the reference's stream, with ``tests/test_torch_lm.py``'s bars
    and AdamW caveat."""
    steps, accum = 3, 2
    bundle = jreg.bundle_from_cfg(JCFG)
    init_state, jstep = jtrain.make_train_step(
        bundle, JParallel(grad_accum=accum, remat="full"), JTrain(lr=1e-3, warmup=0, steps=steps))
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

    arch = treg.bundle_from_cfg(TCFG, "cpu")
    init, step = make_train_step(arch, ParallelConfig(grad_accum=accum, remat="full"),
                                 TrainConfig(lr=1e-3, warmup=0, steps=steps))
    st = init(0)._replace(params=lm_params_from_jax(params0, "cpu"))
    tspecs = arch.input_specs(ShapeConfig("t", 16, 4, "train"))
    losses, vs = [], []
    for s in range(steps):
        st, m = step(st, tsyn.place(tsyn.synth_batch(tspecs, TCFG, 0, s), "cpu"))
        losses.append(float(m["loss"]))
        vs.append([v.clone() for v in tree_leaves(st.opt["v"])])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got, wanted = _named(st.params), _named(want)
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


def test_launchers_run_the_id_on_cpu(capsys):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    assert train_main(["--arch", NAME, "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "32", "--grad-accum", "2"]) == 0
    out = capsys.readouterr().out
    assert f"model: {NAME} layers=2" in out and "done: steps=2 restarts=0" in out
    assert serve_main(["--device", "cpu", "--arch", NAME, "--requests", "3", "--slots", "2",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
