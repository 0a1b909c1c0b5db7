"""The port's LM serving slice (reduced Qwen2-7B and Mamba2-780m, fp32)
against the JAX package.

Params are initialised by JAX and handed over with ``lm_params_from_jax``,
caches with ``lm_caches_from_jax``; tokens come from numpy.  On the CPU
RMSNorm (B6) takes its plain version.
- ``decode_step``'s logits and every cache leaf against JAX's over 12 steps
  (14 through the sliding-window ring) from two slots at unequal lengths,
  within ``tests/test_torch_lm.py``'s 1e-5; a slot's batch-1 view writes
  that slot alone, and each batch row decodes as it would alone;
- the port's decode against its own full forward, at the reference's bar
  (``tests/test_attention.py:94-96``), and ``prefill``;
- the engine: greedy answers equal a greedy loop over the reference's
  ``apply_lm`` for each prompt alone, whatever else is served; slot
  recycling, EOS, ``max_new_tokens``, ``prefill_calls``; the sampler;
- the launcher's LM mode on the CPU;
- a window cache shorter than its window: the reference's decode drops
  context (ROADMAP C.11), the port's engine refuses the request;
- the reference engine's faults beside the port's repair: a request's answer
  depends on the other slots (ROADMAP C.8), and the prompt's last token is
  fed twice (C.9).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_780m as jmamba_cfg
from repro.configs import qwen2_7b as jqwen_cfg
from repro.models import lm as jlm
from repro.models import registry as jreg
from repro.serve import engine as jeng
from repro_torch.configs import mamba2_780m as tmamba_cfg
from repro_torch.configs import qwen2_7b as tqwen_cfg
from repro_torch.interop import lm_caches_from_jax, lm_params_from_jax
from repro_torch.launch.mesh import make_virtual_mesh
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.models.attention import KVCache, MLACache
from repro_torch.models.mamba2 import MambaState
from repro_torch.parallel.api import sharding_ctx
from repro_torch.serve import engine as teng

ATOL = 1e-5          # tests/test_torch_lm.py: apply_lm, loss and every grad leaf
DECODE_BAR = dict(atol=2e-2, rtol=2e-2)     # tests/test_attention.py:94-96
SWA = 8
CFGS = {
    "qwen2": (jqwen_cfg.reduced(), tqwen_cfg.reduced()),
    "mamba2": (jmamba_cfg.reduced(), tmamba_cfg.reduced()),
    "qwen2_swa": (dataclasses.replace(jqwen_cfg.reduced(), swa_window=SWA),
                  dataclasses.replace(tqwen_cfg.reduced(), swa_window=SWA)),
}
# the greedy reference runs apply_lm at one padded length (one compile); both
# mixers are causal, so position t's logits see tokens 0..t only
REF_LEN = 64


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


_PARAMS = {}


def _params(name):
    """(JAX params, the port's) of CFGS[name], seed 0 (the SWA twin shares
    qwen2's: a window adds no param)."""
    key = name.replace("_swa", "")
    if key not in _PARAMS:
        jp = jlm.init_lm(jax.random.PRNGKey(0), CFGS[key][0])
        _PARAMS[key] = (jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return _PARAMS[key]


def _cache_leaves(caches):
    return [t for c in caches for t in c]


def _greedy_reference(name):
    """prompt -> its greedy continuation of n tokens, by the reference's
    full forward on the prompt alone (no cache)."""
    jcfg = CFGS[name][0]
    jp, _ = _params(name)

    @jax.jit
    def logits_at(tokens):
        hidden = jlm.apply_lm(jp, tokens, jcfg)
        return (hidden[0] @ jlm.lm_head_weight(jp, jcfg).astype(jcfg.act_dtype).T).astype(
            jnp.float32)

    def greedy(prompt, n):
        seq = [int(t) for t in prompt]
        for _ in range(n):
            buf = np.zeros((1, REF_LEN), np.int32)
            buf[0, :len(seq)] = seq
            seq.append(int(jnp.argmax(logits_at(jnp.asarray(buf))[len(seq) - 1])))
        return seq[len(prompt):]

    return greedy


# ---------------------------------------------------------------------------
# decode_step against JAX's
# ---------------------------------------------------------------------------


def _started_caches(name, rng, max_seq):
    """JAX caches of two slots after 7 decoded tokens, the KV slots then set
    to unequal lengths (3 and 7; the rows past 3 are stale and masked).  A
    Mamba2 state has one scalar length in JAX; its two slots hold different
    states."""
    jcfg = CFGS[name][0]
    jp, _ = _params(name)
    caches = jlm.init_caches(jcfg, 2, max_seq, jcfg.act_dtype)
    dec = jax.jit(lambda c, t: jlm.decode_step(jp, t, c, jcfg))
    for _ in range(7):
        _, caches = dec(caches, jnp.asarray(rng.integers(0, jcfg.vocab, (2, 1), dtype=np.int32)))
    return [c._replace(lengths=jnp.asarray([3, 7], jnp.int32)) if hasattr(c, "lengths") else c
            for c in caches]


@pytest.mark.parametrize("name,steps", [("qwen2", 12), ("mamba2", 12), ("qwen2_swa", 14)])
def test_decode_step_and_caches_match_jax(name, steps):
    jcfg, tcfg = CFGS[name]
    jp, tp = _params(name)
    rng = np.random.default_rng(1)
    jc = _started_caches(name, rng, 16 if name == "qwen2_swa" else 24)
    tc = lm_caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    if name == "qwen2_swa":
        assert tc[0].k.shape[1] == SWA          # a ring of the window, wrapped by 7 + 14 steps
    objs = list(tc)
    dec = jax.jit(lambda c, t: jlm.decode_step(jp, t, c, jcfg))
    for step in range(steps):
        tok = rng.integers(0, jcfg.vocab, (2, 1), dtype=np.int32)
        jl, jc = dec(jc, jnp.asarray(tok))
        tl, tc2 = tlm.decode_step(tp, torch.from_numpy(tok), tc, tcfg)
        assert tc2 is tc and all(a is b for a, b in zip(tc, objs))     # written in place
        assert tl.dtype == torch.float32 and tl.shape == (2, 1, tcfg.vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0,
                                   err_msg=f"logits, step {step}")
        for i, (a, b) in enumerate(zip(jax.tree.leaves(jc), _cache_leaves(tc))):
            a = np.asarray(a)
            assert b.dtype == getattr(torch, str(a.dtype)), (i, b.dtype, a.dtype)
            np.testing.assert_allclose(b.numpy(), np.broadcast_to(a, b.shape), atol=ATOL, rtol=0,
                                       err_msg=f"cache leaf {i}, step {step}")


@pytest.mark.parametrize("name", ["qwen2", "mamba2", "qwen2_swa"])
def test_a_slot_view_writes_its_slot_and_each_row_decodes_alone(name):
    """What the engine's independence rests on.  A decode through batch-1
    views of slot 1 (the prefill's path) writes slot 1 alone and leaves
    slot 0 bit for bit; a decode of both slots gives slot 0 the logits and
    cache rows a batch of slot 0 alone gives, whatever slot 1 holds."""
    _, tcfg = CFGS[name]
    _, tp = _params(name)
    rng = np.random.default_rng(2)
    caches = lm_caches_from_jax(jax.tree.map(np.asarray, _started_caches(name, rng, 16)), "cpu")
    alone = [type(c)(*(t[:1].clone() for t in c)) for c in caches]
    tok = torch.from_numpy(rng.integers(0, tcfg.vocab, (2, 1), dtype=np.int32))
    slot0 = [t[0].clone() for t in _cache_leaves(caches)]
    other = [type(c)(*(t[1:].clone() for t in c)) for c in caches]
    for _ in range(3):
        got, _ = tlm.decode_step(tp, tok[1:], [c.slot(1) for c in caches], tcfg)
        want, _ = tlm.decode_step(tp, tok[1:], other, tcfg)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)
    for a, b in zip(_cache_leaves(caches), slot0):
        assert torch.equal(a[0], b)
    for a, b in zip(_cache_leaves(caches), _cache_leaves(other)):
        np.testing.assert_allclose(a[1:].numpy(), b.numpy(), atol=ATOL, rtol=0)
    for _ in range(3):
        got, _ = tlm.decode_step(tp, tok, caches, tcfg)
        want, _ = tlm.decode_step(tp, tok[:1], alone, tcfg)
        np.testing.assert_allclose(got[:1].numpy(), want.numpy(), atol=ATOL, rtol=0)
    for a, b in zip(_cache_leaves(caches), _cache_leaves(alone)):
        np.testing.assert_allclose(a[:1].numpy(), b.numpy(), atol=ATOL, rtol=0)


def test_caches_and_specs():
    for name in ("qwen2", "mamba2", "qwen2_swa"):
        jcfg, tcfg = CFGS[name]
        arch = treg.bundle_from_cfg(tcfg, "cpu")
        got = arch.make_caches(3, 12)
        spec = arch.cache_specs(3, 12)
        want = jlm.init_caches(jcfg, 3, 12, jcfg.act_dtype)
        assert len(got) == len(spec) == len(want) == tcfg.n_layers
        for g, s, w in zip(got, spec, want):
            assert isinstance(g, {"KVCache": KVCache, "MambaState": MambaState}[type(w).__name__])
            assert g._fields == w._fields
            for gt, st, wt in zip(g, s, w):
                wt = np.asarray(wt)
                # the port keeps a Mamba2 length per slot, the reference one
                shape = wt.shape if wt.ndim else (3,)
                assert tuple(gt.shape) == tuple(st.shape) == shape
                assert gt.dtype == st.dtype == getattr(torch, str(wt.dtype))
                assert st.device.type == "meta" and not bool(gt.any())
    # an MLA config's caches are the compressed MLACache (A.18.4;
    # tests/test_torch_deepseek.py holds them against JAX's); Qwen2-VL's
    # (A.18.5) are KV caches, Whisper's (A.18.6) a WhisperCache per decoder
    # layer (tests/test_torch_vlm.py, test_torch_whisper.py)
    mla = tlm.init_caches(treg.load_config("deepseek-v3-671b", reduced=True), 1, 4,
                          torch.float32)
    assert all(isinstance(c, MLACache) and c.c_kv.shape == (1, 4, 16) for c in mla)
    vlm = treg.get_arch("qwen2-vl-2b", reduced=True, device="cpu").make_caches(1, 4)
    assert all(isinstance(c, KVCache) and c.k.shape == (1, 4, 2, 16) for c in vlm)
    wsp = treg.get_arch("whisper-medium", reduced=True, device="cpu").cache_specs(2, 6)
    assert [tuple(t.shape) for t in wsp[0].tensors()] == [(2, 6, 4, 16)] * 2 + [(2,)] + \
        [(2, 6, 4, 16)] * 2 and wsp[0].cross_k.device.type == "meta"


def test_decode_raises_for_the_unported_decode_paths():
    """The sequence-sharded decode (A.18.8) runs: on 2 shards of the
    ``seq_shard`` axis, 6 steps from two slots, the logits and caches of the
    unsharded decode (tests/test_torch_seq_shard.py holds the attention
    against JAX's).  Whisper's bundle, as the reference's, takes no
    ``seq_sharded``: a ``TypeError``."""
    _, tcfg = CFGS["qwen2"]
    arch = treg.bundle_from_cfg(tcfg, "cpu")
    _, tp = _params("qwen2")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab, (2, 6))
                              .astype(np.int32))
    plain, sharded = arch.make_caches(2, 8), arch.make_caches(2, 8)
    for t in range(tokens.shape[1]):
        want, _ = arch.decode_fn(tp, tokens[:, t:t + 1], plain)
        with sharding_ctx(make_virtual_mesh({"model": 2}, "cpu")):
            got, _ = arch.decode_fn(tp, tokens[:, t:t + 1], sharded, seq_sharded=True)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    for a, b in zip(plain, sharded):
        for x, y in zip(a, b):
            torch.testing.assert_close(y, x, rtol=0, atol=1e-5)
    wsp = treg.get_arch("whisper-medium", reduced=True, device="cpu")
    with pytest.raises(TypeError, match="seq_sharded"):
        wsp.decode_fn(wsp.init(0), tokens[:1, :1], wsp.make_caches(1, 4), seq_sharded=True)


# ---------------------------------------------------------------------------
# decode against the port's own full forward; prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen2", "mamba2", "qwen2_swa"])
def test_decode_matches_the_full_forward(name):
    _, tcfg = CFGS[name]
    _, tp = _params(name)
    steps = 14 if name == "qwen2_swa" else 12
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, tcfg.vocab, (2, steps),
                                                                 dtype=np.int32))
    head = tlm.lm_head_weight(tp, tcfg).to(tcfg.act_dtype)
    full = (tlm.apply_lm(tp, tokens, tcfg) @ head.T).float()
    caches = treg.bundle_from_cfg(tcfg, "cpu").make_caches(2, steps)
    if name == "qwen2_swa":
        assert caches[0].k.shape[1] == SWA < steps
    outs = [tlm.decode_step(tp, tokens[:, t:t + 1], caches, tcfg)[0][:, 0] for t in range(steps)]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), **DECODE_BAR)


@pytest.mark.parametrize("name", ["qwen2", "mamba2"])
def test_prefill_returns_the_last_logits_and_the_caches_untouched(name):
    jcfg, tcfg = CFGS[name]
    jp, tp = _params(name)
    tokens = np.random.default_rng(4).integers(0, jcfg.vocab, (2, 32), dtype=np.int32)
    jl, _ = jlm.prefill(jp, jnp.asarray(tokens), jcfg, [])
    caches = treg.bundle_from_cfg(tcfg, "cpu").make_caches(2, 32)
    tl, out = tlm.prefill(tp, torch.from_numpy(tokens), tcfg, caches)
    assert out is caches and not any(bool(t.any()) for t in _cache_leaves(caches))
    assert tl.dtype == torch.float32 and tl.shape == (2, 1, tcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _engine(name, **kw):
    _, tcfg = CFGS[name]
    _, tp = _params(name)
    return teng.ServeEngine(treg.bundle_from_cfg(tcfg, "cpu"), tp, **kw)


def _prompts(n, seed=5, lo=3, hi=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("name", ["qwen2", "mamba2"])
def test_engine_greedy_answers_equal_the_reference_forward_per_prompt(name):
    """7 requests over 3 slots, unequal prompt and answer lengths, so slots
    recycle while others decode: each answer is the greedy continuation of
    its prompt alone by the reference's full forward."""
    eng = _engine(name, batch=3, max_seq=32)
    prompts = _prompts(7)
    news = [6, 3, 8, 2, 5, 7, 4]
    for rid, (p, n) in enumerate(zip(prompts, news)):
        eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=n))
    done = eng.run(max_ticks=200)
    assert sorted(r.rid for r in done) == list(range(7))
    assert eng.prefill_calls == 7 and eng.prefill_tokens == sum(len(p) - 1 for p in prompts)
    greedy = _greedy_reference(name)
    for r in done:
        assert r.done and r.out_tokens == greedy(r.prompt, news[r.rid]), r.rid


def test_engine_recycles_slots_and_counts_admissions():
    eng = _engine("qwen2", batch=1, max_seq=32)
    for i in range(3):
        eng.submit(teng.Request(rid=i, prompt=np.asarray([i + 1, 7], np.int32), max_new_tokens=3))
    done = eng.run(max_ticks=300)
    assert [r.rid for r in done] == [0, 1, 2]
    assert all(len(r.out_tokens) == 3 for r in done)
    assert eng.prefill_calls == 3 and eng.prefill_tokens == 3 and eng.decode_calls == 9
    assert eng.slots == [None] and not eng.queue
    # a recycled slot starts from zeroed caches: the last request answers as alone
    alone = _engine("qwen2", batch=1, max_seq=32)
    alone.submit(teng.Request(rid=2, prompt=np.asarray([3, 7], np.int32), max_new_tokens=3))
    assert alone.run()[0].out_tokens == done[2].out_tokens


def test_engine_eos_and_max_new_tokens():
    prompt = np.asarray([1, 2, 3], np.int32)
    eng = _engine("mamba2", batch=2, max_seq=32)
    eng.submit(teng.Request(rid=0, prompt=prompt, max_new_tokens=8))
    first = eng.run(max_ticks=100)[0].out_tokens[0]

    eng2 = _engine("mamba2", batch=2, max_seq=32, eos_id=int(first))
    eng2.submit(teng.Request(rid=0, prompt=prompt, max_new_tokens=8))
    eng2.submit(teng.Request(rid=1, prompt=np.asarray([9, 9, 9, 9], np.int32), max_new_tokens=5))
    out = {r.rid: r for r in eng2.run(max_ticks=100)}
    assert out[0].out_tokens == [first]
    assert 1 <= len(out[1].out_tokens) <= 5
    assert len(out[1].out_tokens) == 5 or out[1].out_tokens[-1] == first


def test_engine_refuses_a_request_its_full_kv_cache_cannot_hold():
    eng = _engine("qwen2", batch=2, max_seq=8)
    eng.submit(teng.Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=5))
    with pytest.raises(ValueError, match="max_seq is 8"):
        eng.submit(teng.Request(rid=1, prompt=np.arange(4, dtype=np.int32), max_new_tokens=6))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(teng.Request(rid=2, prompt=np.zeros(0, np.int32)))
    # a ring or an SSM state holds any length
    for name in ("qwen2_swa", "mamba2"):
        _engine(name, batch=1, max_seq=8).submit(
            teng.Request(rid=0, prompt=np.arange(12, dtype=np.int32), max_new_tokens=12))


def _over_the_bar(got, want):
    """Per position (axis 1): whether some logit misses ``DECODE_BAR``."""
    d = np.abs(got - want) - (DECODE_BAR["atol"] + DECODE_BAR["rtol"] * np.abs(want))
    return (d > 0).any(axis=(0, 2))


def test_reference_ring_shorter_than_its_window_drops_context_c11():
    """ROADMAP C.11: at ``max_seq`` 4 a layer of window 8 keeps a ring of 4
    rows, so the reference's decode at positions >= 4 sees only the last 4
    and misses its own full forward; at ``max_seq`` 8 (ring = window) it
    holds.  The port's engine refuses a request whose positions such a ring
    would drop, and serves the same request at ``max_seq`` 8."""
    jcfg, tcfg = CFGS["qwen2_swa"]
    jp, _ = _params("qwen2_swa")
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (1, 14), dtype=np.int32)
    full = np.asarray((jlm.apply_lm(jp, jnp.asarray(tokens), jcfg)
                       @ jlm.lm_head_weight(jp, jcfg).T).astype(jnp.float32))
    dec = jax.jit(lambda c, t: jlm.decode_step(jp, t, c, jcfg))
    for max_seq in (4, SWA):
        caches = jlm.init_caches(jcfg, 1, max_seq, jcfg.act_dtype)
        assert caches[0].k.shape[1] == max_seq            # min(max_seq, window) rows
        outs = []
        for t in range(tokens.shape[1]):
            logits, caches = dec(caches, jnp.asarray(tokens[:, t:t + 1]))
            outs.append(np.asarray(logits)[:, 0])
        over = _over_the_bar(np.stack(outs, 1), full)
        if max_seq == SWA:
            assert not over.any(), np.flatnonzero(over)
        else:
            assert not over[:4].any() and over[4:].all(), over
    prompt = tokens[0, :10]
    with pytest.raises(ValueError, match=r"max_seq is 4 \(below the sliding window of 8\)"):
        _engine("qwen2_swa", batch=1, max_seq=4).submit(
            teng.Request(rid=0, prompt=prompt, max_new_tokens=4))
    eng = _engine("qwen2_swa", batch=1, max_seq=SWA)
    eng.submit(teng.Request(rid=0, prompt=prompt, max_new_tokens=4))
    assert eng.run()[0].out_tokens == _greedy_reference("qwen2_swa")(prompt, 4)


def test_sampler():
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal((4, 2, 50)).astype(
        np.float32))
    assert torch.equal(teng.sample_logits(logits), logits[:, -1].argmax(-1))
    assert torch.equal(teng.sample_logits(logits, torch.Generator().manual_seed(0), 0.0),
                       logits[:, -1].argmax(-1))

    def draws(seed, t=1.0, lg=logits):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([teng.sample_logits(lg, g, t) for _ in range(200)])

    assert torch.equal(draws(0), draws(0))
    assert not torch.equal(draws(0), draws(1))
    # a token of probability zero is never drawn
    masked = logits.clone()
    masked[..., 1::2] = -float("inf")
    got = draws(3, 2.0, masked)
    assert bool((got % 2 == 0).all())
    assert len(set(got.flatten().tolist())) > 5


def test_engine_sampling_is_reproducible_from_its_seed():
    def run(seed):
        eng = _engine("qwen2", batch=2, max_seq=32, temperature=1.0, seed=seed)
        for rid, p in enumerate(_prompts(3, seed=7)):
            eng.submit(teng.Request(rid=rid, prompt=p, max_new_tokens=6))
        return {r.rid: r.out_tokens for r in eng.run()}

    assert run(0) == run(0)
    assert run(0) != run(1)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-780m"])
def test_lm_serve_launcher_runs_on_cpu(arch, capsys):
    from repro_torch.launch.serve import main

    assert main(["--device", "cpu", "--arch", arch, "--requests", "3", "--slots", "2",
                 "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out
    assert out.count("req ") == 3


def test_lm_serve_launcher_names_the_roadmap_item_of_an_unported_arch(capsys):
    """Every ``--arch`` is ported now: ``stablelm-1.6b`` (A.18.2),
    ``mixtral-8x22b`` (A.18.3), ``deepseek-v3-671b`` (A.18.4),
    ``qwen2-vl-2b`` (A.18.5) and ``whisper-medium`` (A.18.6) serve, and
    ``stablelm-1.6b`` is the default ``--arch``, as in the reference; an id
    the reference lacks is refused by the parser."""
    from repro_torch.launch.serve import main

    for argv in (["--arch", "stablelm-1.6b"], [], ["--arch", "mixtral-8x22b"],
                 ["--arch", "deepseek-v3-671b"], ["--arch", "qwen2-vl-2b"],
                 ["--arch", "whisper-medium"]):
        assert main(["--device", "cpu", "--requests", "2", "--max-new", "3"] + argv) == 0
        out = capsys.readouterr().out
        assert "served 2 requests, 6 tokens" in out and "on cpu" in out
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--arch", "gpt-5"])


# ---------------------------------------------------------------------------
# the reference engine's faults (ROADMAP C.8, C.9) beside the port's repair
# ---------------------------------------------------------------------------

# C.8's case: prompts of 5, 9 and 7 tokens, 8 new tokens each, on 2 slots
C8_LENGTHS, C8_NEW = (5, 9, 7), 8


def _c8_prompts():
    rng = np.random.default_rng(8)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in C8_LENGTHS]


def _serve(engine, request, prompts):
    """Each request's answer tokens, by rid, from ``engine`` serving
    ``prompts`` (``request``: the engine's Request class)."""
    for rid, p in enumerate(prompts):
        engine.submit(request(rid=rid, prompt=p, max_new_tokens=C8_NEW))
    return {r.rid: r.out_tokens for r in engine.run(max_ticks=500)}


@pytest.mark.parametrize("name", ["qwen2", "mamba2"])
def test_reference_engine_leaks_state_across_slots_c8(name):
    """The reference engine: every decode writes and advances every slot, the
    bulk prefill feeds token 0 into the other slots, and a freed slot is not
    reset - so a request's answer depends on what else is served.  The port's
    answers are the same together and alone, and equal the greedy
    continuation by the reference's forward."""
    jcfg, tcfg = CFGS[name]
    jp, tp = _params(name)
    prompts = _c8_prompts()

    def ref(slots):
        return jeng.ServeEngine(jreg.bundle_from_cfg(jcfg), jp, batch=slots, max_seq=64)

    def port(slots):
        return teng.ServeEngine(treg.bundle_from_cfg(tcfg, "cpu"), tp, batch=slots, max_seq=64)

    ref_together = _serve(ref(2), jeng.Request, prompts)
    ref_alone = [_serve(ref(1), jeng.Request, [p])[0] for p in prompts]
    assert [ref_together[i] != a for i, a in enumerate(ref_alone)] == [True] * 3

    port_together = _serve(port(2), teng.Request, prompts)
    port_alone = [_serve(port(1), teng.Request, [p])[0] for p in prompts]
    greedy = _greedy_reference(name)
    assert [port_together[i] for i in range(3)] == port_alone == [greedy(p, C8_NEW)
                                                                   for p in prompts]

    # after one admission (and its first tick) into a 2-slot engine, the
    # reference has fed the prompt's last token twice and advanced the free
    # slot with it; the port has fed the admitted slot its n prompt tokens
    r, t = ref(2), port(2)
    r.submit(jeng.Request(rid=0, prompt=prompts[0], max_new_tokens=C8_NEW))
    t.submit(teng.Request(rid=0, prompt=prompts[0], max_new_tokens=C8_NEW))
    r.tick()
    t.tick()
    n = len(prompts[0])
    if name == "qwen2":
        assert np.asarray(r.caches[0].lengths).tolist() == [n + 1, n + 1]
    assert int(t.caches[0][-1][0]) == n


def test_reference_engine_feeds_the_prompts_last_token_twice_c9():
    """The reference prefill scans the whole prompt into the cache, then its
    first tick feeds ``prompt[-1]`` again at position T: the first answer
    token is the greedy continuation of ``prompt + [prompt[-1]]``.  The
    port's is the continuation of the prompt."""
    prompts = _prompts(6, seed=9, lo=3, hi=12)
    missed = 0
    for name in ("qwen2", "mamba2"):
        jcfg, tcfg = CFGS[name]
        jp, tp = _params(name)
        greedy = _greedy_reference(name)
        for p in prompts:
            ref = jeng.ServeEngine(jreg.bundle_from_cfg(jcfg), jp, batch=1, max_seq=32)
            ref.submit(jeng.Request(rid=0, prompt=p, max_new_tokens=1))
            got_ref = ref.run()[0].out_tokens[0]
            port = teng.ServeEngine(treg.bundle_from_cfg(tcfg, "cpu"), tp, batch=1, max_seq=32)
            port.submit(teng.Request(rid=0, prompt=p, max_new_tokens=1))
            got_port = port.run()[0].out_tokens[0]
            assert got_ref == greedy(np.append(p, p[-1]), 1)[0]
            assert got_port == greedy(p, 1)[0]
            missed += got_ref != got_port
    assert missed, "the reference's first token no longer differs from greedy(prompt) anywhere"
