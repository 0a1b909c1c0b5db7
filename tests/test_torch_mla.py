"""MLA, DeepSeek-V3's multi-head latent attention (``models/attention.py``:
``init_attention``'s MLA branch, ``mla_attention``, ``MLACache`` and the
absorbed decode ``_decode_mla``), against the JAX reference's functions at
DeepSeek-V3's reduced config, fp32.

Params are drawn by JAX and handed over as numpy, with seeded noise on the
two norm scales (ones at init); on the CPU the RMSNorm op (B6) takes its
plain version.  Bars: ``tests/test_torch_lm.py``'s 1e-5 for the forward,
its gradients and the decode; the reference's 2e-2
(``tests/test_attention.py:94-96``) for the absorbed decode against the
full forward, the two being different arithmetic for the same function.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v3_671b as jds
from repro.models import attention as jattn
from repro_torch.configs import deepseek_v3_671b as tds
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import attention as tattn

ATOL = 1e-5                                  # tests/test_torch_lm.py
DECODE_BAR = dict(atol=2e-2, rtol=2e-2)      # tests/test_attention.py:94-96
JCFG, TCFG = jds.reduced(), tds.reduced()


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _params(seed=0):
    """(JAX params, the port's) of one MLA layer, norms perturbed."""
    p = jax.tree.map(np.asarray, jattn.init_attention(jax.random.PRNGKey(seed), JCFG,
                                                      jnp.float32))
    rng = np.random.default_rng(seed + 11)
    for k in ("q_norm", "kv_norm"):
        p[k] = (p[k] + 0.3 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return jax.tree.map(jnp.asarray, p), lm_params_from_jax(p, "cpu")


def _x(b, t, seed=1):
    return np.random.default_rng(seed).standard_normal((b, t, JCFG.d_model)).astype(np.float32)


def test_init_draws_the_reference_leaves_with_its_fan_ins(monkeypatch):
    """Eight leaves, keys, shapes and dtypes as the reference's, the norms
    ones, each drawn leaf scaled by the reference's fan-in."""
    import repro.models.attention as jattn_mod
    import repro_torch.models.attention as tattn_mod

    seen = {"jax": [], "torch": []}

    def spy(mod, real, who):
        def f(key, shape, dtype, fan_in=None):
            seen[who].append((tuple(shape), fan_in if fan_in is not None else shape[0]))
            return real(key, shape, dtype, fan_in=fan_in)
        monkeypatch.setattr(mod, "dense_init", f)

    spy(jattn_mod, jattn_mod.dense_init, "jax")
    spy(tattn_mod, tattn_mod.dense_init, "torch")
    jp = jattn_mod.init_attention(jax.random.PRNGKey(0), JCFG, jnp.float32)
    tp = tattn_mod.init_attention(torch.Generator().manual_seed(0), TCFG, torch.float32)
    assert list(tp) == ["w_dq", "q_norm", "w_uq", "w_dkv", "kv_norm", "w_uk", "w_uv", "w_o"]
    assert sorted(tp) == sorted(jp)
    for k in tp:
        assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32, k
    for k in ("q_norm", "kv_norm"):
        assert torch.equal(tp[k], torch.ones_like(tp[k]))
    assert seen["torch"] == seen["jax"] and len(seen["torch"]) == 6
    bf16 = tattn_mod.init_attention(torch.Generator().manual_seed(0), TCFG, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in bf16.values())


@pytest.mark.parametrize("b,t,offset", [(2, 12, 0), (1, 9, 5), (1, 2048, 0)])
def test_mla_attention_and_its_grads_match_jax(b, t, offset):
    """The forward and the gradients of x and every leaf: at arange
    positions, at positions offset by 5, and at 2048 tokens, where both
    packages' ``_sdpa`` stream over KV chunks (qk head dim 24, v 16).  A
    gradient is held within 1e-5 of its largest entry where that passes 1:
    a norm scale's gradient sums 2048 rows of O(100) entries, which fp32
    rounds at ~1e-6 of the sum in each package."""
    jp, tp = _params()
    x = _x(b, t)
    pos = np.broadcast_to(np.arange(offset, offset + t, dtype=np.int32), (b, t))
    w = np.random.default_rng(2).standard_normal((b, t, JCFG.d_model)).astype(np.float32)

    def jloss(p, x_):
        return jnp.sum(jattn.mla_attention(p, x_, jnp.asarray(pos), JCFG) * w)

    jout = np.asarray(jattn.mla_attention(jp, jnp.asarray(x), jnp.asarray(pos), JCFG))
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    tout = tattn.mla_attention(tp, tx, torch.from_numpy(pos.copy()).long(), TCFG)
    np.testing.assert_allclose(tout.detach().numpy(), jout, atol=ATOL)
    (tout * torch.from_numpy(w)).sum().backward()
    for name, got, want in [("x", tx.grad, jgx)] + [(k, tp[k].grad, jgp[k]) for k in tp]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL * max(1.0, np.abs(want).max()),
                                   err_msg=name)


def test_the_shared_rope_key_rotates_at_the_query_positions():
    """The rotary part is relative: shifting every position alike leaves
    the output as it was (the one shared key head turns with the queries),
    while spreading the positions apart moves it."""
    _, tp = _params()
    x = torch.from_numpy(_x(1, 10))
    pos = torch.arange(10)[None]
    base = tattn.mla_attention(tp, x, pos, TCFG)
    shifted = tattn.mla_attention(tp, x, pos + 3, TCFG)
    spread = tattn.mla_attention(tp, x, 2 * pos, TCFG)
    np.testing.assert_allclose(shifted.numpy(), base.numpy(), atol=ATOL)
    assert float((spread - base).abs().max()) > 100 * ATOL


def _caches(b, s, lengths, seed=3):
    """A JAX ``MLACache`` of noise rows with the given lengths, and the
    port's copy of it."""
    from repro_torch.interop import lm_caches_from_jax

    rng = np.random.default_rng(seed)
    m = JCFG.mla
    c = jattn.MLACache(rng.standard_normal((b, s, m.kv_lora_rank)).astype(np.float32),
                       rng.standard_normal((b, s, m.qk_rope_head_dim)).astype(np.float32),
                       np.asarray(lengths, np.int32))
    return jax.tree.map(jnp.asarray, c), lm_caches_from_jax([c], "cpu")[0]


def test_decode_mla_and_its_cache_match_jax():
    """Two slots at lengths 3 and 7 of a 9-row cache, 6 steps: slot 1 runs
    past the last row, where both write the clamped row ``S - 1``.  The
    outputs, every cache leaf and the lengths after each step."""
    jp, tp = _params()
    jc, tc = _caches(2, 9, [3, 7])
    assert isinstance(tc, tattn.MLACache) and tc.c_kv.shape == (2, 9, 16)
    dec = jax.jit(lambda c, x: jattn._decode_mla(jp, x, c, JCFG))
    rng = np.random.default_rng(4)
    for step in range(6):
        x = rng.standard_normal((2, 1, JCFG.d_model)).astype(np.float32)
        jy, jc = dec(jc, jnp.asarray(x))
        ty, out = tattn._decode_mla(tp, torch.from_numpy(x), tc, TCFG)
        assert out is tc and ty.shape == (2, 1, JCFG.d_model)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, err_msg=str(step))
        for a, b_ in zip(tc, jc):
            np.testing.assert_allclose(a.numpy(), np.asarray(b_), atol=ATOL, err_msg=str(step))
    assert tc.lengths.tolist() == [9, 13] and tc.lengths.dtype == torch.int32


def test_decode_attention_dispatches_to_the_absorbed_form():
    _, tp = _params()
    _, tc = _caches(1, 6, [2])
    _, tc2 = _caches(1, 6, [2])
    x = torch.from_numpy(_x(1, 1))
    y, out = tattn.decode_attention(tp, x, tc, TCFG)
    want, _ = tattn._decode_mla(tp, x, tc2, TCFG)
    assert out is tc and torch.equal(y, want) and torch.equal(tc.c_kv, tc2.c_kv)


def test_absorbed_decode_matches_the_full_forward():
    """Token by token from an empty cache, the absorbed decode gives the
    full forward's output at each position, at the reference's bar and in
    fact within 1e-5."""
    _, tp = _params()
    x = torch.from_numpy(_x(2, 14))
    full = tattn.mla_attention(tp, x, torch.arange(14)[None].expand(2, 14), TCFG)
    m = TCFG.mla
    cache = tattn.MLACache.init(2, 14, m.kv_lora_rank, m.qk_rope_head_dim, torch.float32)
    dec = torch.cat([tattn._decode_mla(tp, x[:, t:t + 1], cache, TCFG)[0] for t in range(14)], 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **DECODE_BAR)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=ATOL)
    assert cache.lengths.tolist() == [14, 14]


def test_mla_cache_slot_views_write_through():
    m = TCFG.mla
    cache = tattn.MLACache.init(3, 5, m.kv_lora_rank, m.qk_rope_head_dim, torch.float32)
    assert [tuple(t.shape) for t in cache] == [(3, 5, 16), (3, 5, 8), (3,)]
    assert cache.lengths.dtype == torch.int32
    _, tp = _params()
    view = cache.slot(1)
    assert isinstance(view, tattn.MLACache) and view.c_kv.shape == (1, 5, 16)
    tattn._decode_mla(tp, torch.from_numpy(_x(1, 1)), view, TCFG)
    assert cache.lengths.tolist() == [0, 1, 0]
    assert bool(cache.c_kv[1, 0].any()) and not bool(cache.c_kv[[0, 2]].any())
    assert bool(cache.k_pe[1, 0].any()) and not bool(cache.k_pe[1, 1:].any())
    for t in view:
        t.zero_()
    assert not any(bool(t.any()) for t in cache)


def test_kv_norm_takes_a_strided_view_of_the_projection():
    """``c_kv`` is a view of rows of rank + dr; the norm op copies it
    contiguous before its kernel, whose wrapper refuses a strided x."""
    from repro_torch.models.common import rms_norm

    _, tp = _params()
    full = torch.from_numpy(_x(2, 5)) @ tp["w_dkv"]
    view = full[..., :TCFG.mla.kv_lora_rank]
    assert not view.is_contiguous()
    assert torch.equal(rms_norm(view, tp["kv_norm"]), rms_norm(view.contiguous(), tp["kv_norm"]))
