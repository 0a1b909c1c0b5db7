"""The port's Mixture-of-Experts (``models/mlp.py``: ``_route``, ``moe``,
``moe_aux_loss``) and adafactor (``optim/optimizers.py``) against the
reference's, on the same numpy inputs.

The MoE cases are those of ``tests/test_moe.py``, each held against the
reference's own ``moe`` within 1e-5 (params drawn by JAX and handed over):
ample capacity (with and without a shared expert), tight capacity, where
the same assignments must drop, the group-local dispatch with the group
count patched to 4 in both packages, grads to every param group, the aux
loss, and top-1 routing equal to argmax; plus ties broken as ``lax.top_k``
breaks them and the capacity rule.  Adafactor: a factored stacked leaf
(every reduced width is below ``_factored``'s 128), the update's RMS
clipped over a whole stacked leaf, and the in-place mode by slices against
the out-of-place one, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mlp as jmlp
import repro_torch.models.mlp as tmlp
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.optim import optimizers as jopt
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.jamba_v0_1_52b import CONFIG as JAMBA
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL
from repro_torch.interop import lm_params_from_jax
from repro_torch.optim import optimizers as topt

ATOL = 1e-5


def _cfgs(n_experts=4, top_k=2, cf=8.0, shared=0):
    """``tests/test_moe.py``'s config in both packages."""
    kw = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=0,
              vocab=32, dtype="float32", param_dtype="float32")
    moe = dict(n_experts=n_experts, top_k=top_k, d_ff_expert=32, n_shared_experts=shared,
               d_ff_shared=32, capacity_factor=cf)
    return (JModelConfig(moe=JMoEConfig(**moe), **kw), ModelConfig(moe=MoEConfig(**moe), **kw))


def _params(jcfg, seed=0):
    """(JAX params, the port's) of ``init_moe``, drawn by JAX."""
    jp = jmlp.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _jax_keep(jp, x, jcfg):
    """Which (token, k) assignments the reference keeps: its own routing and
    queue positions (``repro/models/mlp.py:moe``), one group."""
    m = jcfg.moe
    n = x.shape[0] * x.shape[1]
    _, topi, _ = jmlp._route(jp["router"], jnp.asarray(x).reshape(n, -1), m)
    cap = max(1, int(n * m.top_k * m.capacity_factor) // m.n_experts)
    if n * m.top_k <= 512:
        cap = max(cap, n)
    oh = jax.nn.one_hot(topi, m.n_experts, dtype=jnp.int32).reshape(n * m.top_k, -1)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
    return np.asarray(pos < cap).reshape(n, m.top_k)


def _port_keep(tp, x, tcfg):
    m = tcfg.moe
    n = x.shape[0] * x.shape[1]
    _, topi, _ = tmlp._route(tp["router"], torch.from_numpy(x).reshape(1, n, -1), m)
    return tmlp.queue_positions(topi, m.n_experts, tmlp.moe_capacity(n, m))[1][0].numpy()


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_matches_jax_when_capacity_ample(shared):
    jcfg, tcfg = _cfgs(cf=8.0, shared=shared)
    jp, tp = _params(jcfg)
    x = _x((2, 16, 16))
    want = np.asarray(jmlp.moe(jp, jnp.asarray(x), jcfg))
    got = tmlp.moe(tp, torch.from_numpy(x), tcfg)
    assert got.shape == (2, 16, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert _port_keep(tp, x, tcfg).all()


def test_moe_drops_the_same_assignments_as_jax_when_capacity_tight():
    """cf 0.25 at (4, 128, 16): 1024 assignments, past the dropless floor of
    512, capacity 64 an expert; the port keeps exactly the assignments the
    reference keeps, and the outputs agree."""
    jcfg, tcfg = _cfgs(cf=0.25)
    jp, tp = _params(jcfg)
    x = _x((4, 128, 16))
    assert tmlp.moe_capacity(512, tcfg.moe) == 64
    keep = _port_keep(tp, x, tcfg)
    np.testing.assert_array_equal(keep, _jax_keep(jp, x, jcfg))
    assert keep.sum() == 4 * 64                       # every expert's queue full
    want = np.asarray(jmlp.moe(jp, jnp.asarray(x), jcfg))
    got = tmlp.moe(tp, torch.from_numpy(x), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # a token whose every assignment dropped gets zero from the experts
    gone = ~keep.any(axis=1)
    assert gone.any() and np.all(got.reshape(-1, 16)[gone] == 0)
    ample = tmlp.moe(tp, torch.from_numpy(x), _cfgs(cf=8.0)[1]).numpy()
    assert not np.allclose(got, ample, atol=1e-3)


def test_moe_grouped_dispatch_matches_jax_with_the_group_count_patched(monkeypatch):
    """Four groups in both packages: the capacity and the cumsum run per
    group.  Ample capacity: the grouped dispatch equals the global one too."""
    jcfg, tcfg = _cfgs(cf=8.0)
    jp, tp = _params(jcfg)
    x = _x((4, 8, 16))
    glob = tmlp.moe(tp, torch.from_numpy(x), tcfg)
    monkeypatch.setattr(jmlp, "_dispatch_groups", lambda b: 4)
    monkeypatch.setattr(tmlp, "_dispatch_groups", lambda b: 4)
    want = np.asarray(jmlp.moe(jp, jnp.asarray(x), jcfg))
    got = tmlp.moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), glob.numpy(), atol=ATOL)


def test_moe_grouped_dispatch_drops_per_group_as_jax(monkeypatch):
    """Tight capacity over four groups: each group drops on its own queue."""
    jcfg, tcfg = _cfgs(cf=0.25)
    jp, tp = _params(jcfg)
    x = _x((4, 256, 16), seed=4)
    monkeypatch.setattr(jmlp, "_dispatch_groups", lambda b: 4)
    monkeypatch.setattr(tmlp, "_dispatch_groups", lambda b: 4)
    want = np.asarray(jmlp.moe(jp, jnp.asarray(x), jcfg))
    got = tmlp.moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_moe_grads_to_every_param_group_match_jax():
    """The loss of ``tests/test_moe.py`` (a sum of squares) gives gradients of
    up to ~500, so each leaf is held within 1e-5 of its largest entry."""
    jcfg, tcfg = _cfgs(cf=8.0, shared=1)
    jp, tp = _params(jcfg)
    x = _x((2, 8, 16))
    jg = jax.grad(lambda p: jnp.sum(jmlp.moe(p, jnp.asarray(x), jcfg) ** 2))(jp)
    live = jax.tree.map(lambda t: t.detach().requires_grad_(True), tp)
    leaves = jax.tree.leaves(live)
    torch.sum(tmlp.moe(live, torch.from_numpy(x), tcfg) ** 2).backward()
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(jg), leaves):
        key = jax.tree_util.keystr(path)
        assert got.grad is not None and bool(torch.any(got.grad != 0)), key
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, atol=ATOL * np.abs(want).max(),
                                   err_msg=key)
    assert {"router", "w_gate", "w_up", "w_down", "shared"} == set(tp)


def test_moe_aux_loss_matches_jax_balanced_and_collapsed():
    jcfg, tcfg = _cfgs(n_experts=4, top_k=1)
    jp, tp = _params(jcfg)
    x = _x((2, 32, 16))
    balanced = float(tmlp.moe_aux_loss(tp, torch.from_numpy(x), tcfg))
    assert balanced == pytest.approx(float(jmlp.moe_aux_loss(jp, jnp.asarray(x), jcfg)),
                                     rel=1e-6)
    # the router collapsed onto expert 0 (ties among the other three)
    jc = dict(jp, router=jnp.zeros_like(jp["router"]).at[:, 0].set(10.0))
    tc = dict(tp, router=torch.zeros_like(tp["router"]))
    tc["router"][:, 0] = 10.0
    worse = float(tmlp.moe_aux_loss(tc, torch.from_numpy(x), tcfg))
    assert worse == pytest.approx(float(jmlp.moe_aux_loss(jc, jnp.asarray(x), jcfg)), rel=1e-6)
    assert worse > balanced


def test_moe_top1_routing_is_argmax():
    jcfg, tcfg = _cfgs(n_experts=8, top_k=1, cf=8.0)
    jp, tp = _params(jcfg)
    xf = torch.from_numpy(_x((8, 16)))
    topw, topi, gates = tmlp._route(tp["router"], xf, tcfg.moe)
    np.testing.assert_array_equal(topi[:, 0].numpy(), torch.argmax(gates, dim=-1).numpy())
    assert torch.all(topw == 1.0)
    _, jtopi, _ = jmlp._route(jp["router"], jnp.asarray(xf.numpy()), jcfg.moe)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))


@pytest.mark.parametrize("cf", [8.0, 0.5])
def test_moe_combine_at_top8_adds_each_row_in_a_fixed_order(cf):
    """DeepSeek-V3's top-8 (of 16 here): the combine adds a token's k
    outputs by a gather and k adds in slot order, the order of the
    reference's scatter-add, and runs no ``index_add`` (on a card an
    index_add adds a row's contributions by atomics, in any order, and at
    top-8 another order gives other bits).  Against JAX with ample and with
    tight capacity; and on the dropless floor a token's output is the same
    bits whatever the other tokens are (a decode row computed on its own)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.add(str(func))
            return func(*args, **(kwargs or {}))

    jcfg, tcfg = _cfgs(n_experts=16, top_k=8, cf=cf, shared=1)
    jp, tp = _params(jcfg)
    x = _x((2, 40, 16))
    want = np.asarray(jmlp.moe(jp, jnp.asarray(x), jcfg))
    with Ops() as ops:
        got = tmlp.moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    assert not any("index_add" in n for n in ops.names), sorted(ops.names)
    assert _port_keep(tp, x, tcfg).all() == (cf == 8.0)
    # dropless (3 tokens x 8 = 24 assignments): token 0's row alone and beside others
    a = torch.from_numpy(_x((3, 1, 16), seed=2))
    b = a.clone()
    b[1:] = torch.from_numpy(_x((2, 1, 16), seed=3))
    assert torch.equal(tmlp.moe(tp, a, tcfg)[0], tmlp.moe(tp, b, tcfg)[0])


def test_route_breaks_ties_as_lax_top_k():
    """A zero router gives every expert the same gate: ``lax.top_k`` takes
    the lowest indices first, and so does the port (``torch.topk`` does not
    promise it)."""
    jcfg, tcfg = _cfgs(n_experts=8, top_k=2)
    xf = _x((5, 16))
    _, jtopi, _ = jmlp._route(jnp.zeros((16, 8)), jnp.asarray(xf), jcfg.moe)
    topw, topi, _ = tmlp._route(torch.zeros(16, 8), torch.from_numpy(xf), tcfg.moe)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    np.testing.assert_array_equal(topi.numpy(), np.tile([0, 1], (5, 1)))
    assert torch.all(topw == 0.5)


@pytest.mark.parametrize("cfg,n,cap", [
    (MIXTRAL, 4096, 1280),     # a training microbatch of 2 x 2048 tokens
    (JAMBA, 4096, 640),
    (MIXTRAL, 4, 4),           # a decode call of 4 slots: dropless
    (MIXTRAL, 256, 256),       # 512 assignments: still dropless
    (MIXTRAL, 257, 80),        # one token more: capacity n * k * cf / E
    (JAMBA, 1, 1),
])
def test_moe_capacity(cfg, n, cap):
    assert tmlp.moe_capacity(n, cfg.moe) == cap


def test_bf16_and_fp32_drop_the_same_assignments_on_bf16_inputs():
    """The router runs in fp32 on ``x.float()``, so an input that bf16 holds
    exactly routes and drops the same in bf16 as in fp32, in the reference
    and the port alike (a question recorded in ROADMAP C)."""
    jcfg, tcfg = _cfgs(cf=0.25)
    jp, tp = _params(jcfg)
    x = torch.from_numpy(_x((4, 128, 16))).to(torch.bfloat16).float().numpy()
    keep32 = _port_keep(tp, x, tcfg)
    bcfg = dataclasses.replace(tcfg, dtype="bfloat16", param_dtype="bfloat16")
    keep16 = _port_keep(tp, torch.from_numpy(x).to(torch.bfloat16).float().numpy(), bcfg)
    np.testing.assert_array_equal(keep16, keep32)
    np.testing.assert_array_equal(keep32, _jax_keep(jp, x, jcfg))
    out = tmlp.moe({k: v.to(torch.bfloat16) if k != "router" else v for k, v in tp.items()},
                   torch.from_numpy(x).to(torch.bfloat16), bcfg)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


def test_reference_draws_the_expert_weights_at_fan_in_e_c12():
    """ROADMAP C.12: ``dense_init``'s fan-in defaults to a shape's first dim,
    which for the stacked (E, D, F) ``w_gate`` and ``w_up`` is the expert
    count: they are drawn at std 1/sqrt(E), not 1/sqrt(D) (``w_down`` names
    its fan-in F).  The port draws the same, so the MoE layers' outputs at
    init run sqrt(D/E) larger than a dense MLP's (in the hundreds at
    Mixtral's and Jamba's widths)."""
    jcfg, tcfg = _cfgs(n_experts=4)
    jp = jmlp.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = tmlp.init_moe(torch.Generator().manual_seed(0), tcfg, torch.float32)
    for p in (jax.tree.map(np.asarray, jp), {k: v.numpy() for k, v in tp.items()}):
        for key in ("w_gate", "w_up"):
            assert np.std(p[key]) == pytest.approx(1 / np.sqrt(4), rel=0.05), key
        assert np.std(p["w_down"]) == pytest.approx(1 / np.sqrt(32), rel=0.05)
        # 64 draws: the estimate itself spreads ~9 %
        assert np.std(p["router"]) == pytest.approx(1 / np.sqrt(16), rel=0.3)


# ---------------------------------------------------------------------------
# adafactor
# ---------------------------------------------------------------------------


def _adafactor_run(shapes, grads, inplace, dtype=torch.float32, steps=3, lr=1e-2):
    rng = np.random.default_rng(7)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
              for k, s in shapes.items()}
    opt = topt.make_optimizer("adafactor", weight_decay=0.1, inplace=inplace)
    state = opt.init(params)
    for g in grads[:steps]:
        params, state = opt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()},
                                   state, params, lr)
    return params, state


def _grads(shapes, steps=3, seed=8, scale=None):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        if scale is not None:
            g = {k: v * scale.get(k, 1.0) for k, v in g.items()}
        out.append(g)
    return out


SHAPES = {"stacked": (2, 128, 256), "matrix": (130, 200), "narrow": (2, 64, 128),
          "vector": (9,)}


def test_adafactor_matches_jax_on_factored_and_full_leaves():
    """A stacked (2, 128, 256) leaf and a (130, 200) matrix are factored (row
    and column statistics per matrix), the narrow and 1-D leaves keep a full
    second moment; 3 steps within 1e-5 of the reference."""
    grads = _grads(SHAPES)
    params, state = _adafactor_run(SHAPES, grads, inplace=False)
    jo = jopt.make_optimizer("adafactor", weight_decay=0.1)
    rng = np.random.default_rng(7)
    jp = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    js = jo.init(jp)
    for g in grads:
        jp, js = jo.update(g, js, jp, 1e-2)
    assert state["t"] == int(js["t"]) == 3
    for k in SHAPES:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jp[k]), atol=ATOL, err_msg=k)
        assert set(state["v"][k]) == set(js["v"][k]), k
        for s in state["v"][k]:
            want = np.asarray(js["v"][k][s])
            assert state["v"][k][s].shape == want.shape
            np.testing.assert_allclose(state["v"][k][s].numpy(), want, rtol=1e-5, err_msg=k)
    assert set(state["v"]["stacked"]) == {"vr", "vc"} and set(state["v"]["narrow"]) == {"v"}
    assert state["v"]["stacked"]["vr"].shape == (2, 128)


def test_adafactor_clips_the_rms_over_the_whole_stacked_leaf():
    """Two steps on a stacked leaf: the same gradient for both repeats, then
    repeat 1's scaled by 0.01.  Adafactor's step RMS is then ~7 on repeat 0
    and ~0.1 on repeat 1: the clip over the whole leaf, as the reference's,
    divides both by the leaf's RMS (~5), where a clip per repeat would divide
    repeat 0's by ~7 and leave repeat 1's."""
    shapes = {"w": (2, 128, 128)}
    g1 = _grads(shapes, steps=1)[0]["w"]
    g1[1] = g1[0]
    g2 = g1.copy()
    g2[1] *= 0.01
    grads = [{"w": g1}, {"w": g2}]
    params, _ = _adafactor_run(shapes, grads, inplace=False, steps=2)
    jo = jopt.make_optimizer("adafactor", weight_decay=0.1)

    def jax_run(p0, gs):
        p, st = {"w": p0}, jo.init({"w": p0})
        for g in gs:
            p, st = jo.update({"w": g}, st, p, 1e-2)
        return np.asarray(p["w"])

    p0 = np.random.default_rng(7).standard_normal((2, 128, 128)).astype(np.float32)
    whole = jax_run(p0, [g1, g2])
    np.testing.assert_allclose(params["w"].numpy(), whole, atol=ATOL)
    per_repeat = np.stack([jax_run(p0[r], [g1[r], g2[r]]) for r in range(2)])
    assert all(np.abs(per_repeat[r] - whole[r]).max() > 1e-4 for r in range(2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inplace_adafactor_by_slices_gives_the_out_of_place_bits(monkeypatch, dtype):
    """``INPLACE_CHUNK`` patched so that the stacked leaf runs one matrix a
    slice and the full leaves split unevenly: in place and out of place give
    the same params and statistics, bit for bit, and the in-place update
    writes the tensors it was given; unsliced, the same update within
    rounding."""
    grads = _grads(SHAPES)
    unsliced = _adafactor_run(SHAPES, grads, inplace=False, dtype=dtype)
    monkeypatch.setattr(topt, "INPLACE_CHUNK", 5)
    outs = []
    for inplace in (False, True):
        params, state = _adafactor_run(SHAPES, grads, inplace=inplace, dtype=dtype)
        outs.append(topt.tree_leaves(params) + topt.tree_leaves(state["v"]))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(outs[0], topt.tree_leaves(unsliced[0]) + topt.tree_leaves(unsliced[1]["v"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=1e-5,
                                   atol=1e-6 if dtype == torch.float32 else 1e-2)
    # in place: the tensors given are the ones returned
    params = {k: torch.zeros(s, dtype=dtype) for k, s in SHAPES.items()}
    opt = topt.make_optimizer("adafactor", inplace=True)
    state = opt.init(params)
    vr = state["v"]["stacked"]["vr"]
    new_p, new_s = opt.update({k: torch.from_numpy(v) for k, v in grads[0].items()}, state,
                              params, 1e-2)
    assert all(new_p[k] is params[k] for k in SHAPES) and new_s["v"]["stacked"]["vr"] is vr
    assert bool(vr.any())
