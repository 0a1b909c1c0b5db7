"""Whisper-medium (ROADMAP A.18.6: the encoder-decoder, cross-attention) at
its reduced config (2 + 2 layers, d_model 64, 4 heads, LayerNorm, GELU),
fp32, against the JAX package.

Params are initialised by JAX (``init_whisper``) and handed over with
``lm_params_from_jax``; every norm and MLP bias leaf gets the same seeded
numpy noise in both packages first.  On the CPU the flash-attention op
(B4) takes its plain version; JAX's ``_sdpa`` its naive mode.
- the config, the registry's specs and ``synth_batch``'s bits, the params
  leaf for leaf;
- ``_sinusoid``, ``cross_attention_kv``, ``attention`` with ``kv_override``,
  ``encode``, ``decode_train``, ``whisper_loss`` and every grad leaf, remat
  ``none``, ``full`` and ``dots`` (the reference checkpoints the whole body
  for any remat but ``none``), within 1e-5 (FP64_RULE where fp32 rounding
  parts the packages by more);
- ``init_whisper_caches`` and ``whisper_decode_step`` against JAX's, with
  zeroed cross K/V (as the reference serves) and with them filled from
  ``cross_attention_kv(encode(frames))``, where the decode also meets
  ``decode_train``'s logits;
- ROADMAP C.15 (the reference's serving never writes the cross K/V, so its
  answers do not depend on the cross-attention weights; the port mirrors
  it) and C.16 (the reference reads NaN past ``dec_pos``'s 8192 rows; the
  port's engine refuses such a request);
- the engine's greedy answers against JAX's decode per prompt, 3 AdamW
  steps with ``grad_accum`` 2 against JAX's trainer, and both launchers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import whisper_medium as jwm
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ShapeConfig as JShape
from repro.configs.base import TrainConfig as JTrain
from repro.data import synthetic as jsyn
from repro.models import attention as jattn
from repro.models import registry as jreg
from repro.models import whisper as jw
from repro.train import trainer as jtrain
from repro_torch.configs import whisper_medium as twm
from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.data import synthetic as tsyn
from repro_torch.interop import lm_caches_from_jax, lm_params_from_jax
from repro_torch.models import attention as tattn
from repro_torch.models import registry as treg
from repro_torch.models import whisper as tw
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.serve import engine as teng
from repro_torch.train.trainer import lm_value_and_grad, make_train_step

NAME = "whisper-medium"
ATOL = 1e-5                                  # tests/test_torch_lm.py
PARAM_ATOL = 1e-5
NORM_RTOL = 1e-4                             # FP64_RULE (tests/test_torch_vlm.py)
FP64_FACTOR = 2.0
ADAM_WELL_CONDITIONED = 1e-6                 # tests/test_torch_lm.py
ADAM_ILL_SHARE = 5e-3
DECODE_BAR = dict(atol=2e-2, rtol=2e-2)      # tests/test_attention.py:94-96
JCFG, TCFG = jwm.reduced(), twm.reduced()
T_ENC, T_DEC = 32, 8                         # the registry's frames : tokens at seq 32


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _perturbed(tree):
    """Every norm leaf and MLP bias plus seeded noise, the rest as given."""
    rng = np.random.default_rng(12)

    def leaf(path, a):
        key = jax.tree_util.keystr(path)
        if "norm" in key or "'b_" in key:
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


_PARAMS = {}


def _params():
    """(JAX params, the same as numpy, the port's) of the reduced config."""
    if not _PARAMS:
        npp = _perturbed(jax.tree.map(np.asarray, jw.init_whisper(jax.random.PRNGKey(0), JCFG)))
        _PARAMS["p"] = (jax.tree.map(jnp.asarray, npp), npp, lm_params_from_jax(npp, "cpu"))
    return _PARAMS["p"]


def _named(tree, prefix=""):
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
    d = float(np.abs(got - want).max())
    if d <= ATOL:
        return
    assert float(np.abs(want - exact).max()) <= NORM_RTOL * float(np.abs(want).max()), (what, d)
    assert _rms(got - exact) <= FP64_FACTOR * _rms(want - exact), (what, d)


def _ref_batch(seq=T_ENC, batch=2, seed=0, step=0):
    specs = jreg.bundle_from_cfg(JCFG).input_specs(JShape("t", seq, batch, "train"))
    return jsyn.synth_batch(specs, JCFG, seed, step)


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# config, specs, params
# ---------------------------------------------------------------------------


def test_config_specs_and_batches_match_the_reference():
    assert treg.load_config(NAME) == twm.CONFIG and treg.load_config(NAME, reduced=True) == TCFG
    for jc, tc in ((jwm.CONFIG, twm.CONFIG), (JCFG, TCFG)):
        for f in dataclasses.fields(jc):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    # with_depth scales the encoder with the decoder, as the reference's
    for n in (1, 6, 24):
        assert dataclasses.asdict(treg.with_depth(twm.CONFIG, n)) == \
            dataclasses.asdict(jreg.with_depth(jwm.CONFIG, n))
    assert treg.with_depth(twm.CONFIG, 6).n_encoder_layers == 6
    for seq, batch in ((32, 2), (16, 4), (2048, 1)):
        want = jreg.bundle_from_cfg(JCFG).input_specs(JShape("t", seq, batch, "train"))
        got = treg.bundle_from_cfg(TCFG, "cpu").input_specs(ShapeConfig("t", seq, batch, "train"))
        assert list(got) == list(want) == ["frames", "tokens", "labels"]
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert str(got[k].dtype).replace("torch.", "") == str(np.dtype(want[k].dtype)), k
    assert tuple(got["tokens"].shape) == (1, 512)
    w = _ref_batch(seed=3, step=2)
    g = tsyn.synth_batch(treg.bundle_from_cfg(TCFG, "cpu").input_specs(
        ShapeConfig("t", T_ENC, 2, "train")), TCFG, 3, 2)
    np.testing.assert_array_equal(g["frames"].numpy(), w["frames"])
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(g[k], w[k])


def test_params_convert_leaf_for_leaf():
    _, npp, tp = _params()
    got, want = _named(tp), _named(npp)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, n
        np.testing.assert_array_equal(a.numpy(), b, err_msg=n)
    assert tp["dec_pos"].shape == (tw.DEC_POS_ROWS, TCFG.d_model)
    assert tp["enc"]["mlp"]["b_up"].shape == (2, TCFG.d_ff)
    own = treg.bundle_from_cfg(TCFG, "cpu").init(0)
    assert [(n, tuple(a.shape), a.dtype) for n, a in _named(own)] == \
        [(n, tuple(a.shape), a.dtype) for n, a in got]
    bf16 = dataclasses.replace(TCFG, dtype="bfloat16", param_dtype="bfloat16")
    assert all(a.dtype == torch.bfloat16
               for _, a in _named(treg.bundle_from_cfg(bf16, "cpu").init(0)))


# ---------------------------------------------------------------------------
# the module's functions
# ---------------------------------------------------------------------------


def test_sinusoid_and_cross_attention_match_jax():
    jp, _, tp = _params()
    for t, d in ((32, 64), (2048, 1024)):
        # at 2048 frames the fp32 angles' rounding (ulp 1.2e-4 at 2047 rad)
        # parts both packages from the float64 sinusoid, and each other by
        # up to 6.1e-5: held by FP64_RULE's RMS half against float64
        pos = np.arange(t, dtype=np.float64)[:, None]
        ang = pos / np.power(10000.0, 2 * np.arange(d // 2, dtype=np.float64)[None] / d)
        exact = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
        got = tw._sinusoid(t, d, torch.float32, "cpu").numpy().astype(np.float64)
        want = np.asarray(jw._sinusoid(t, d, jnp.float32)).astype(np.float64)
        assert np.abs(want - exact).max() <= 2e-4 and np.abs(got - exact).max() <= 2e-4
        assert _rms(got - exact) <= FP64_FACTOR * _rms(want - exact), t
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((2, T_ENC, TCFG.d_model)).astype(np.float32)
    h = rng.standard_normal((2, T_DEC, TCFG.d_model)).astype(np.float32)
    ja, ta = _layer(jp["dec"]["xattn"], 1), _layer(tp["dec"]["xattn"], 1)
    jkv = jattn.cross_attention_kv(ja, jnp.asarray(enc), JCFG)
    tkv = tattn.cross_attention_kv(ta, torch.from_numpy(enc), TCFG)
    for a, b in zip(tkv, jkv):
        assert a.shape == (2, T_ENC, TCFG.n_kv_heads, TCFG.resolved_head_dim)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    pos = np.broadcast_to(np.arange(T_DEC, dtype=np.int32), (2, T_DEC))
    want = jattn.attention(ja, jnp.asarray(h), jnp.asarray(pos), JCFG, causal=False,
                           kv_override=jkv)
    got = tattn.attention(ta, torch.from_numpy(h), torch.from_numpy(pos.copy()), TCFG,
                          causal=False, kv_override=tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # causal cross-attention at other positions takes the plain _sdpa, as the reference
    later = pos + 5
    want = jattn.attention(ja, jnp.asarray(h), jnp.asarray(later), JCFG, causal=True,
                           kv_override=jkv)
    got = tattn.attention(ta, torch.from_numpy(h), torch.from_numpy(later), TCFG, causal=True,
                          kv_override=tkv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_encode_decode_train_loss_and_grads_match_jax(remat):
    jp, _, tp = _params()
    batch = _ref_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = tsyn.place(batch, "cpu")
    jenc = jw.encode(jp, jb["frames"], JCFG, remat=remat)
    tenc = tw.encode(tp, tb["frames"], TCFG, remat=remat)
    enc64 = tw.encode(_fp64(tp), tb["frames"], _cfg64(TCFG), remat=remat)
    _close(tenc.detach().numpy(), np.asarray(jenc), enc64.detach().numpy(), "encode")
    jh = jw.decode_train(jp, jb["tokens"], jenc, JCFG, remat=remat)
    th = tw.decode_train(tp, tb["tokens"], tenc, TCFG, remat=remat)
    h64 = tw.decode_train(_fp64(tp), tb["tokens"], enc64, _cfg64(TCFG), remat=remat)
    _close(th.detach().numpy(), np.asarray(jh), h64.detach().numpy(), "decode_train")
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jw.whisper_loss(p, jb, JCFG, remat=remat, ce_chunk=6)))(jp)
    tl, tg = lm_value_and_grad(
        lambda p, bt: tw.whisper_loss(p, bt, TCFG, remat=remat, ce_chunk=6), tp, tb)
    _, g64 = lm_value_and_grad(
        lambda p, bt: tw.whisper_loss(p, bt, _cfg64(TCFG), remat=remat, ce_chunk=6),
        _fp64(tp), tb)
    assert abs(float(tl) - float(jl)) <= ATOL * max(1.0, abs(float(jl)))
    got, want, exact = _named(tg), _named(jax.tree.map(np.asarray, jg)), _named(g64)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, w), (_, e) in zip(got, want, exact):
        assert n == "/dec_pos" or float(a.abs().max()) > 0, n
        _close(a.numpy(), w, e.numpy(), n)
    # the registry's loss is the same function
    arch = treg.bundle_from_cfg(TCFG, "cpu")
    assert float(arch.loss_fn(tp, tb, remat=remat, ce_chunk=6)) == float(tl)


def test_remat_checkpoints_the_whole_body():
    """remat "full" and "dots" save only each layer's input (the same
    number of saved tensors as each other, fewer than "none"), and give the
    same loss and grads."""
    _, _, tp = _params()
    tb = tsyn.place(_ref_batch(), "cpu")
    counts, grads = {}, {}
    for remat in ("none", "full", "dots"):
        n = [0]

        def pack(t, n=n):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            live = jax.tree.map(lambda p: p.detach().requires_grad_(True), tp)
            loss = tw.whisper_loss(live, tb, TCFG, remat=remat)
        counts[remat] = n[0]
        grads[remat] = torch.autograd.grad(loss, tree_leaves(live))
    assert counts["full"] == counts["dots"] < counts["none"]
    for g_full, g_dots, g_none in zip(grads["full"], grads["dots"], grads["none"]):
        assert torch.equal(g_full, g_dots)
        torch.testing.assert_close(g_full, g_none, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# serving: caches, decode, C.15, C.16
# ---------------------------------------------------------------------------


def _caches_pair(jp, tp, frames, filled: bool):
    """JAX's and the port's caches for 2 slots of 16 rows (the cross K/V of
    T_ENC rows), zeroed, or with the cross K/V of ``encode(frames)``."""
    jc = jw.init_whisper_caches(JCFG, 2, 16, T_ENC, JCFG.act_dtype)
    if filled:
        enc = jw.encode(jp, jnp.asarray(frames), JCFG)
        for i in range(JCFG.n_layers):
            k, v = jattn.cross_attention_kv(_layer(jp["dec"]["xattn"], i), enc, JCFG)
            jc[i] = dict(jc[i], cross_k=k, cross_v=v)
    return jc, lm_caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")


@pytest.mark.parametrize("filled", [False, True])
def test_decode_step_and_caches_match_jax(filled):
    """Two slots, 9 steps, from zeroed cross K/V (the reference's serving)
    or from the encoder's; slot 1 starts 3 tokens later."""
    jp, _, tp = _params()
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((2, T_ENC, TCFG.d_model)).astype(np.float32)
    jc, tc = _caches_pair(jp, tp, frames, filled)
    assert all(isinstance(c, tw.WhisperCache) for c in tc)
    dec = jax.jit(lambda c, t: jw.whisper_decode_step(jp, t, c, JCFG))
    for _ in range(3):
        tok = rng.integers(0, JCFG.vocab, (2, 1), dtype=np.int32)
        _, jc = dec(jc, jnp.asarray(tok))
        tw.whisper_decode_step(tp, torch.from_numpy(tok), tc, TCFG)
    jc = [dict(c, self=c["self"]._replace(lengths=jnp.asarray([3, 0], jnp.int32))) for c in jc]
    for c in tc:
        c.attn.lengths.copy_(torch.tensor([3, 0]))
    for step in range(9):
        tok = rng.integers(0, JCFG.vocab, (2, 1), dtype=np.int32)
        jl, jc = dec(jc, jnp.asarray(tok))
        tl, _ = tw.whisper_decode_step(tp, torch.from_numpy(tok), tc, TCFG)
        assert tl.dtype == torch.float32 and tl.shape == (2, 1, TCFG.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg=str(step))
        for c_j, c_t in zip(jc, tc):
            for a, b in ((c_j["self"].k, c_t.attn.k), (c_j["self"].v, c_t.attn.v),
                         (c_j["cross_k"], c_t.cross_k), (c_j["cross_v"], c_t.cross_v)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)
            assert c_t.attn.lengths.tolist() == np.asarray(c_j["self"].lengths).tolist()
    assert [c.attn.lengths.tolist() for c in tc] == [[12, 9]] * TCFG.n_layers


def test_decode_with_filled_cross_caches_meets_decode_train():
    """With the cross K/V of ``encode(frames)`` (``fill_cross_caches``),
    decoding teacher-forced tokens one by one gives ``decode_train``'s
    logits at the reference's bar (the C.15 check's working half)."""
    _, _, tp = _params()
    rng = np.random.default_rng(8)
    frames = torch.from_numpy(rng.standard_normal((2, T_ENC, TCFG.d_model)).astype(np.float32))
    tokens = torch.from_numpy(rng.integers(0, TCFG.vocab, (2, 12), dtype=np.int32))
    enc = tw.encode(tp, frames, TCFG)
    full = (tw.decode_train(tp, tokens, enc, TCFG) @ tp["embed"].T).float()
    caches = treg.bundle_from_cfg(TCFG, "cpu").make_caches(2, 16)
    assert caches[0].cross_k.shape[1] == 16          # enc_len = max_seq, as the reference's
    caches = tw.init_whisper_caches(TCFG, 2, 16, T_ENC, torch.float32)
    tw.fill_cross_caches(tp, caches, enc, TCFG)
    outs = [tw.whisper_decode_step(tp, tokens[:, t:t + 1], caches, TCFG)[0][:, 0]
            for t in range(12)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), **DECODE_BAR)
    # zeroed cross K/V give other logits: the check sees the encoder
    zero = tw.init_whisper_caches(TCFG, 2, 16, T_ENC, torch.float32)
    outs0 = [tw.whisper_decode_step(tp, tokens[:, t:t + 1], zero, TCFG)[0][:, 0]
             for t in range(12)]
    assert float((torch.stack(outs0, 1) - full).abs().max()) > 0.1


def test_c15_serving_never_sees_the_cross_attention():
    """ROADMAP C.15.  The reference's caches hold zeroed cross K/V that its
    serving never writes, so every cross-attention output is 0: its decode
    gives the same bits with every ``dec.xattn`` weight replaced by 7 w + 1.
    The port's decode from the engine's caches does too (mirrored), and the
    engine leaves the cross K/V zero."""
    jp, _, tp = _params()
    rng = np.random.default_rng(15)
    toks = [rng.integers(0, JCFG.vocab, (2, 1), dtype=np.int32) for _ in range(6)]
    bent_j = dict(jp, dec=dict(jp["dec"], xattn=jax.tree.map(lambda w: 7 * w + 1,
                                                             jp["dec"]["xattn"])))
    bent_t = dict(tp, dec=dict(tp["dec"], xattn=jax.tree.map(lambda w: 7 * w + 1,
                                                             tp["dec"]["xattn"])))

    def jax_logits(p):
        c = jw.init_whisper_caches(JCFG, 2, 16, 16, JCFG.act_dtype)
        out = []
        for t in toks:
            lg, c = jw.whisper_decode_step(p, jnp.asarray(t), c, JCFG)
            out.append(np.asarray(lg))
        return np.stack(out)

    def port_logits(p):
        c = treg.bundle_from_cfg(TCFG, "cpu").make_caches(2, 16)
        return np.stack([tw.whisper_decode_step(p, torch.from_numpy(t), c, TCFG)[0].numpy()
                         for t in toks])

    assert np.array_equal(jax_logits(jp), jax_logits(bent_j))
    assert np.array_equal(port_logits(tp), port_logits(bent_t))
    np.testing.assert_allclose(port_logits(tp), jax_logits(jp), atol=ATOL)
    eng = teng.ServeEngine(treg.bundle_from_cfg(TCFG, "cpu"), tp, batch=2, max_seq=16)
    eng.submit(teng.Request(rid=0, prompt=np.arange(3, 8, dtype=np.int32), max_new_tokens=4))
    assert len(eng.run()) == 1
    assert all(not c.cross_k.any() and not c.cross_v.any() for c in eng.caches)
    assert eng.caches[0].attn.lengths.tolist()[0] == 8


def test_c16_positions_past_dec_pos_read_nan_in_the_reference_and_are_refused():
    """ROADMAP C.16.  ``dec_pos`` has 8192 rows, whatever ``max_pos`` says
    (32776 at full size); the reference's ``jnp.take`` fills NaN past them.
    The port's engine refuses a request that would feed position 8192 or
    later, naming the table, and takes one that ends at 8191."""
    jp, _, _ = _params()
    assert jp["dec_pos"].shape[0] == tw.DEC_POS_ROWS == 8192 < jwm.CONFIG.max_pos
    rows = np.asarray(jnp.take(jp["dec_pos"], jnp.asarray([8191, 8192, 9000]), axis=0))
    assert np.isfinite(rows[0]).all() and np.isnan(rows[1:]).all()
    eng = teng.ServeEngine(treg.bundle_from_cfg(TCFG, "cpu"), None, batch=1, max_seq=9000)
    assert teng._kv_cache_bounds_positions(TCFG, 9000)
    eng.submit(teng.Request(rid=0, prompt=np.zeros(8000, np.int32), max_new_tokens=193))
    with pytest.raises(ValueError, match="position table .* 8192 rows"):
        eng.submit(teng.Request(rid=1, prompt=np.zeros(8000, np.int32), max_new_tokens=194))
    small = teng.ServeEngine(treg.bundle_from_cfg(TCFG, "cpu"), None, batch=1, max_seq=100)
    with pytest.raises(ValueError, match="max_seq is 100"):
        small.submit(teng.Request(rid=2, prompt=np.zeros(100, np.int32), max_new_tokens=2))


def test_engine_greedy_answers_equal_jax_decode_per_prompt():
    """5 token prompts over 2 slots, slots recycled: each answer is the
    greedy continuation of its prompt alone by the reference's decode from
    fresh (zeroed) caches, as the reference's ``_lm_main`` serves it."""
    jp, _, tp = _params()
    eng = teng.ServeEngine(treg.bundle_from_cfg(TCFG, "cpu"), tp, batch=2, max_seq=20)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, JCFG.vocab, size=int(rng.integers(3, 9))).astype(np.int32)
               for _ in range(5)]
    news = [5, 3, 6, 2, 4]
    for rid, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=n))
    done = eng.run(max_ticks=200)
    assert sorted(r.rid for r in done) == list(range(5))
    dec = jax.jit(lambda c, t: jw.whisper_decode_step(jp, t, c, JCFG))
    for r in done:
        c = jw.init_whisper_caches(JCFG, 1, 20, 20, JCFG.act_dtype)
        for t in r.prompt:
            lg, c = dec(c, jnp.asarray([[t]], jnp.int32))
        seq = []
        for _ in range(news[r.rid]):
            seq.append(int(jnp.argmax(lg[0, -1])))
            lg, c = dec(c, jnp.asarray([[seq[-1]]], jnp.int32))
        assert r.out_tokens == seq, r.rid


# ---------------------------------------------------------------------------
# the trainer and the launchers
# ---------------------------------------------------------------------------


def test_train_step_matches_jax_trainer():
    """3 AdamW steps, 2 microbatches, on the reference's stream, with
    ``tests/test_torch_lm.py``'s bars and AdamW caveat."""
    steps, accum = 3, 2
    bundle = jreg.bundle_from_cfg(JCFG)
    init_state, jstep = jtrain.make_train_step(
        bundle, JParallel(grad_accum=accum, remat="full"), JTrain(lr=1e-3, warmup=0, steps=steps))
    state = init_state(jax.random.PRNGKey(0))
    params0 = _perturbed(jax.tree.map(np.asarray, state.params))
    state = state._replace(params=jax.tree.map(jnp.asarray, params0))
    specs = bundle.input_specs(JShape("t", T_ENC, 4, "train"))
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
    tspecs = arch.input_specs(ShapeConfig("t", T_ENC, 4, "train"))
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
                       "--seq", "32", "--remat", "dots"]) == 0
    out = capsys.readouterr().out
    assert f"model: {NAME} layers=2" in out and "done: steps=2 restarts=0" in out
    assert serve_main(["--device", "cpu", "--arch", NAME, "--requests", "3", "--slots", "2",
                       "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
