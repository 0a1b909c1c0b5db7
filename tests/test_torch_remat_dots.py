"""``remat="dots"`` (``models/lm.py:save_dots``) against ``"none"``,
``"full"`` and the reference's ``checkpoint_dots_with_no_batch_dims``.

- the loss and every grad leaf under ``"dots"`` are ``torch.equal`` to
  ``"none"``'s (the same ops on the same values: the recomputation is
  deterministic on the CPU), for six reduced archs, Whisper's whole-body
  checkpoint included;
- the matmul outputs the policy saves against the reference's
  ``saved_residuals`` of one reduced block under its policy, by element
  count: the reference saves what its backward reads, so the port leaves
  to recomputation the projections whose outputs only add into the
  block's output (an MLP's or a shared expert's ``w_down``, a Mamba2
  block's ``w_out``, both of a parallel block's);
- the saved tensors (``saved_tensors_hooks`` outside the checkpoint plus
  the policy's) order ``none > dots > full``;
- a policy that saves ``bmm`` over a real batch too is caught: the scores'
  batched matmul must be recomputed.
~25 s on one worker.
"""
import collections
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals
from torch.utils.checkpoint import CheckpointPolicy

from repro.models import lm as jlm
from repro.models import registry as jreg
from repro_torch.interop import lm_params_from_jax
from repro_torch.models import lm as tlm
from repro_torch.models import registry as treg
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train.trainer import lm_value_and_grad

ARCHS = ["qwen2-7b", "mamba2-780m", "mixtral-8x22b", "deepseek-v3-671b", "qwen2-vl-2b",
         "whisper-medium"]
_aten = torch.ops.aten


def _batch(arch, seed=0):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import synth_batch

    return {k: torch.as_tensor(v) for k, v in synth_batch(
        arch.input_specs(ShapeConfig("t", 32, 2, "train")), arch.cfg, seed, 0).items()}


@pytest.mark.parametrize("name", ARCHS)
def test_dots_loss_and_grads_equal_none_bit_for_bit(name):
    arch = treg.get_arch(name, reduced=True, device="cpu")
    params = arch.init(0)
    batch = _batch(arch)
    out = {r: lm_value_and_grad(lambda p, b, r=r: arch.loss_fn(p, b, remat=r), params, batch)
           for r in ("none", "dots", "full")}
    for remat in ("dots", "full"):
        loss, grads = out[remat]
        assert torch.equal(loss, out["none"][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                                     tree_leaves(out["none"][1]))), remat


def _out_shape(op, args) -> tuple:
    if op is _aten.mm.default:
        return (args[0].shape[0], args[1].shape[1])
    if op is _aten.addmm.default:
        return (args[1].shape[0], args[2].shape[1])
    return (args[0].shape[0], args[0].shape[1], args[1].shape[2])


class _Recorder:
    """``save_dots`` with a record of the outputs it saves in the forward
    (the recomputation's calls are left out)."""

    def __init__(self, policy):
        self.policy, self.saved = policy, []

    def __call__(self, ctx, op, *args, **kwargs):
        got = self.policy(ctx, op, *args, **kwargs)
        if got == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            self.saved.append(_out_shape(op, args))
        return got


def _block(name, b=2, t=16):
    """One reduced block in both packages: (JAX block fn, its args), (the
    port's block params, input, positions, cfg)."""
    jcfg = jreg.load_config(name, reduced=True)
    tcfg = treg.load_config(name, reduced=True)
    jparams = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    seg = jlm.plan_segments(jcfg)[-1]
    jbp = jax.tree.map(lambda a: a[0], jparams["segments"][-1])
    x = np.random.default_rng(0).standard_normal((b, t, jcfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))

    def jblock(x, bp):
        for j, kind in enumerate(seg.block):
            x = jlm._apply_layer(bp[j], kind, x, pos, jcfg)
        return x

    tbp = lm_params_from_jax(jax.tree.map(np.asarray, jbp), "cpu")
    return (jblock, jnp.asarray(x), jbp), (seg, tbp, torch.from_numpy(x), tcfg)


def _port_saved(seg, bp, x, cfg, monkeypatch):
    rec = _Recorder(tlm.save_dots)
    monkeypatch.setattr(tlm, "save_dots", rec)
    pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)

    def fn(x, bp):
        for j, kind in enumerate(seg.block):
            x = tlm._apply_layer(bp[j], kind, x, pos, cfg, arange_positions=True)
        return x

    for a in tree_leaves(bp):
        a.requires_grad_(True)
    unsaved = tlm._block_output_weights(seg.block, bp, cfg)
    y = torch.utils.checkpoint.checkpoint(fn, x, bp, use_reentrant=False,
                                          context_fn=partial(tlm._dots_context, unsaved))
    y.sum().backward()
    return rec.saved


@pytest.mark.parametrize("name", ["qwen2-7b", "mamba2-780m", "mixtral-8x22b", "command-r-35b",
                                  "deepseek-v3-671b", "jamba-v0.1-52b"])
def test_dots_saves_the_references_matmul_outputs(name, monkeypatch):
    (jblock, jx, jbp), (seg, tbp, tx, tcfg) = _block(name)
    policy = jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims
    res = saved_residuals(jax.checkpoint(jblock, policy=policy), jx, jbp)
    # what the reference saves beyond its arguments and constants
    want = collections.Counter(int(np.prod(aval.shape)) for aval, why in res
                               if not why.startswith(("from the argument", "from a constant")))
    got = collections.Counter(int(np.prod(s)) for s in _port_saved(seg, tbp, tx, tcfg,
                                                                  monkeypatch))
    assert got == want, (want, got)


def _saved_count(arch, params, batch, remat, monkeypatch) -> int:
    rec = _Recorder(tlm.save_dots)
    monkeypatch.setattr(tlm, "save_dots", rec)
    n = [0]

    def pack(t):
        n[0] += 1
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = arch.loss_fn(params, batch, remat=remat)
    torch.autograd.grad(loss, tree_leaves(params))
    return n[0] + len(rec.saved)


@pytest.mark.parametrize("name", ["qwen2-7b", "mamba2-780m"])
def test_saved_tensors_order_none_dots_full(name, monkeypatch):
    arch = treg.get_arch(name, reduced=True, device="cpu")
    params = arch.init(0)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    batch = _batch(arch)
    counts = {r: _saved_count(arch, params, batch, r, monkeypatch)
              for r in ("none", "dots", "full")}
    assert counts["none"] > counts["dots"] > counts["full"], counts


def test_a_policy_that_saves_batched_matmuls_saves_more(monkeypatch):
    """The scores' and values' ``bmm`` (batch B*H) are recomputed: a policy
    that saved every ``bmm`` would hold them too."""
    orig = tlm.save_dots
    _, (seg, tbp, tx, tcfg) = _block("qwen2-7b")
    right = _port_saved(seg, tbp, tx, tcfg, monkeypatch)

    def greedy(ctx, op, *args, **kwargs):
        if op is _aten.bmm.default:
            return CheckpointPolicy.MUST_SAVE
        return orig(ctx, op, *args, **kwargs)

    monkeypatch.setattr(tlm, "save_dots", greedy)
    _, (seg, tbp, tx, tcfg) = _block("qwen2-7b")
    wrong = _port_saved(seg, tbp, tx, tcfg, monkeypatch)
    assert len(wrong) > len(right)
    assert any(len(s) == 3 and s[0] > 1 for s in wrong)


def test_remat_rejects_an_unknown_mode():
    arch = treg.get_arch("qwen2-7b", reduced=True, device="cpu")
    with pytest.raises(ValueError, match="'none', 'full', 'dots'"):
        tlm.apply_lm(arch.init(0), torch.zeros((1, 4), dtype=torch.int32), arch.cfg,
                     remat="some")
