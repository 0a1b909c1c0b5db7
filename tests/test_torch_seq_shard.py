"""The port's sequence-sharded operators (``core/sequence.py``,
``models/mamba2.py``, ``models/lm.py``, ``models/attention.py``) against the
JAX package's on the CPU.

The reference runs each under ``shard_map`` over 4 fake CPU devices on axis
``"sp"``, in a subprocess that sets ``XLA_FLAGS`` before it imports jax
(``tests/conftest.py`` keeps pytest on one device); the port runs the same
numpy inputs on a virtual mesh ``{"sp": 4}``, its shards a tensor dimension.
- the five ``core/sequence.py`` functions, forward and VJP;
- ``_ssd_chunk_scan(seq_axis=)`` in ``scripts/check_ssd.py``'s scenario
  (chunk 8), with and without a per-shard initial state, and its VJP;
- ``mamba_block`` and ``apply_lm`` (reduced Mamba2-780m) sharded against the
  reference's sharded and unsharded runs, the loss's grads too;
- ``decode_attend_seq_sharded`` (through ``decode_attention``) on full and
  ring caches against the reference's, on 4 shards and on the 1-shard
  fallback;
- ROADMAP C.17: the reference's sharded ``apply_lm`` attends within each
  shard (2 fake devices), its sharded MoE drops other assignments; the port
  refuses both.
Whole file ~1 min on one worker (two jax subprocesses).
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_780m as jmcfg
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba
from repro.models import registry as jreg
from repro_torch.ckpt.manager import map_with_path
from repro_torch.core import sequence as tseq
from repro_torch.interop import lm_params_from_jax
from repro_torch.kernels.ssd_chunk.ops import ssd_scan
from repro_torch.launch.mesh import make_virtual_mesh
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import registry as treg
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.parallel.api import sharding_ctx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
# where fp32 rounding decides (sums of many terms, the grads of a loss), a
# value is held within this factor of the unsharded fp32 run's own distance
# from fp64, and at least ATOL (chip_smoke.py's GRAD_FLOOR_FACTOR rule)
GRAD_FLOOR_FACTOR = 2.0
S = 4
# check_ssd.py's scenario: b, t, h, p, g, n
SSD = (2, 64, 4, 8, 2, 16)
CONV = (2, 32, 6, 4)          # b, t, d, k
HALO_KV = (2, 32, 2, 4)       # b, t, hkv, dh
WINDOWS = (5, 16)             # 16 > the 8 local tokens: halo 8
MAMBA_T = 256                 # 64 tokens a shard: two chunks of 32


def _rng(seed):
    return np.random.default_rng(seed)


def _inputs() -> dict:
    r = _rng(0)
    b, t, h, p, g, n = SSD
    f32 = np.float32
    mcfg = jmcfg.reduced()
    nh = mcfg.ssm.n_heads(mcfg.d_model)
    d = {
        "ssd_x": r.standard_normal((b, t, h, p)).astype(f32),
        "ssd_dt": np.log1p(np.exp(r.standard_normal((b, t, h)))).astype(f32),
        "ssd_A": (-np.exp(r.standard_normal(h) * 0.5)).astype(f32),
        "ssd_B": (r.standard_normal((b, t, g, n)) * 0.5).astype(f32),
        "ssd_C": (r.standard_normal((b, t, g, n)) * 0.5).astype(f32),
        "ssd_init": (r.standard_normal((S, b, h, n, p)) * 0.5).astype(f32),
        "ssd_ry": r.standard_normal((b, t, h, p)).astype(f32),
        "ssd_rf": r.standard_normal((S, b, h, n, p)).astype(f32),
        "conv_x": r.standard_normal(CONV[:3]).astype(f32),
        "conv_w": r.standard_normal((CONV[3], CONV[2])).astype(f32),
        "conv_b": r.standard_normal(CONV[2]).astype(f32),
        "conv_r": r.standard_normal(CONV[:3]).astype(f32),
        "comb_decay": r.uniform(0.3, 1.0, (S, 2, 3, 1, 1)).astype(f32),
        "hops_decay": r.uniform(0.3, 1.0, (S, 2, 3)).astype(f32),
        "comb_state": r.standard_normal((S, 2, 3, 4, 5)).astype(f32),
        "comb_r": r.standard_normal((S, 2, 3, 4, 5)).astype(f32),
        "kv_k": r.standard_normal(HALO_KV).astype(f32),
        "kv_v": r.standard_normal(HALO_KV).astype(f32),
        "mamba_u": r.standard_normal((2, MAMBA_T, jmcfg.reduced().d_model)).astype(f32),
        "mamba_r": r.standard_normal((2, MAMBA_T, jmcfg.reduced().d_model)).astype(f32),
        "lm_tokens": r.integers(0, jmcfg.reduced().vocab, (2, MAMBA_T)).astype(np.int32),
        "lm_labels": r.integers(0, jmcfg.reduced().vocab, (2, MAMBA_T)).astype(np.int32),
        # per head: A in [0.5, 2], dt ~ softplus(x - 4): a shard of 64 tokens
        # decays by ~e^-1 .. e^-3
        "a_log": np.log(r.uniform(0.5, 2.0, nh)).astype(f32),
        "dt_bias": r.uniform(-5.0, -3.5, nh).astype(f32),
    }
    for w in WINDOWS:
        t_ext = HALO_KV[1] // S + min(w, HALO_KV[1] // S)
        d[f"kv_r{w}"] = r.standard_normal((2, S * t_ext, *HALO_KV[2:])).astype(f32)
    return d


_JAX_SP = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P

from repro.configs import mamba2_780m as mcfg
from repro.core import sequence as seq
from repro.models import lm as L
from repro.models import mamba2 as M

S = %d
WINDOWS = %r
mesh = jax.make_mesh((S,), ("sp",), axis_types=(AxisType.Auto,))
d = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
out = {}
SEQ, SH = P(None, "sp"), P("sp")


def smap(body, in_specs, out_specs):
    return jax.shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)


def rep(a):
    # a replicated input as one copy per shard (its grad sums the copies)
    return jnp.broadcast_to(a, (S,) + a.shape)


def run(name, fn, cots, *args):
    # fn's outputs and the VJP of sum(output * cotangent) in one jitted call
    def loss(*a):
        outs = fn(*a)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, outs), grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(args))),
                                                  has_aux=True))(*args)
    for i, o in enumerate(outs):
        out[f"{name}/out{i}"] = np.asarray(o)
    for i, leaf in enumerate(jax.tree.leaves(grads)):
        out[f"{name}/g/{i}"] = np.asarray(leaf)


conv = smap(lambda x, w, b: seq.seq_halo_conv1d(x, w[0], b[0], "sp"), (SEQ, SH, SH), SEQ)
run("conv", lambda x, w, b: (conv(x, rep(w), rep(b)),), (d["conv_r"],), d["conv_x"],
    d["conv_w"], d["conv_b"])

for name, fn, dec in (("comb", seq.seq_scan_combine, d["comb_decay"]),
                      ("hops", seq.seq_scan_combine_hops, d["hops_decay"])):
    g = smap(lambda a, s, fn=fn: fn(a[0], s[0], "sp")[None], (SH, SH), SH)
    run(name, lambda a, s: (g(a, s),), (d["comb_r"],), dec, d["comb_state"])

for w in WINDOWS:
    h = smap(lambda k, v, w=w: seq.swa_kv_halo(k, v, w, "sp")[:2], (SEQ, SEQ), (SEQ, SEQ))
    run(f"kv{w}", h, (d[f"kv_r{w}"], 2 * d[f"kv_r{w}"]), d["kv_k"], d["kv_v"])
    t_local = d["kv_k"].shape[1] // S
    halo = min(w, t_local)
    pos = smap(lambda dummy, halo=halo: tuple(p[None] for p in seq.swa_position_ids(
        t_local, halo, "sp")), (SH,), (SH, SH))
    q, k = pos(jnp.zeros((S,)))
    out[f"pos{w}/q"], out[f"pos{w}/k"] = np.asarray(q), np.asarray(k)

# _ssd_chunk_scan(seq_axis="sp"), chunk 8, without and with a per-shard initial state
for tag, init in (("ssd", None), ("ssd_init", d["ssd_init"])):
    def body(x, dt, A, B, C, *i):
        y, fin = M._ssd_chunk_scan(x, dt, A[0], B, C, 8, seq_axis="sp",
                                   initial_state=i[0][0] if i else None)
        return y, fin[None]
    n_in = 5 + (init is not None)
    sm = smap(body, (SEQ, SEQ, SH, SEQ, SEQ) + (SH,) * (n_in - 5), (SEQ, SH))
    args = [d["ssd_x"], d["ssd_dt"], d["ssd_A"], d["ssd_B"], d["ssd_C"]] + (
        [init] if init is not None else [])
    run(tag, lambda x, dt, A, B, C, *i: sm(x, dt, rep(A), B, C, *i),
        (d["ssd_ry"], d["ssd_rf"]), *args)

# mamba_block and apply_lm on reduced Mamba2-780m (slow decays), sharded and unsharded
cfg = mcfg.reduced()
params = L.init_lm(jax.random.PRNGKey(0), cfg)
seg = params["segments"][0][0]
slow = {"A_log": jnp.broadcast_to(d["a_log"], seg["mamba"]["A_log"].shape),
        "dt_bias": jnp.broadcast_to(d["dt_bias"], seg["mamba"]["dt_bias"].shape)}
params["segments"][0][0] = {**seg, "mamba": {**seg["mamba"], **slow}}
mp = jax.tree.map(lambda a: a[0], params["segments"][0][0]["mamba"])
blk = smap(lambda u, p: M.mamba_block(jax.tree.map(lambda a: a[0], p), u, cfg, seq_axis="sp"),
           (SEQ, SH), SEQ)
run("block_sharded", lambda u, p: (blk(u, jax.tree.map(rep, p)),), (d["mamba_r"],),
    d["mamba_u"], mp)
run("block_unsharded", lambda u, p: (M.mamba_block(p, u, cfg),), (d["mamba_r"],),
    d["mamba_u"], mp)

lm_sh = smap(lambda t, p: L.apply_lm(jax.tree.map(lambda a: a[0], p), t, cfg, seq_axis="sp"),
             (SEQ, SH), SEQ)
head = lambda p: L.lm_head_weight(p, cfg).astype(cfg.act_dtype)
for tag, fn in (("sharded", lambda p: lm_sh(d["lm_tokens"], jax.tree.map(rep, p))),
                ("unsharded", lambda p: L.apply_lm(p, d["lm_tokens"], cfg))):
    def outs(p, fn=fn):
        hidden = fn(p)
        return hidden, L.chunked_cross_entropy(hidden, head(p), d["lm_labels"])
    run(f"lm_{tag}", outs, (0.0, 1.0), params)
np.savez(sys.argv[2], **out)
'''


def _run(script: str, devices: int, *args) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", script, *map(str, args)], env=env, check=True,
                   timeout=600)


@pytest.fixture(scope="module")
def jax_sp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_shard")
    np.savez(tmp / "in.npz", **_inputs())
    _run(_JAX_SP % (S, WINDOWS), S, tmp / "in.npz", tmp / "out.npz")
    return dict(np.load(tmp / "out.npz"))


def _grads(ref: dict, name: str) -> list:
    n = sum(1 for k in ref if k.startswith(name + "/g/"))
    return [ref[f"{name}/g/{i}"] for i in range(n)]


def _outs(ref: dict, name: str) -> list:
    n = sum(1 for k in ref if k.startswith(name + "/out"))
    return [ref[f"{name}/out{i}"] for i in range(n)]


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _mesh():
    return sharding_ctx(make_virtual_mesh({"sp": S}, "cpu"))


def _t(a, grad=False):
    return torch.tensor(a).requires_grad_(grad)


# ---------------------------------------------------------------------------
# core/sequence.py
# ---------------------------------------------------------------------------


def test_seq_halo_conv1d_matches_the_sharded_reference(jax_sp):
    d = _inputs()
    b, t, dd, _ = CONV
    x, w, bias = _t(d["conv_x"], True), _t(d["conv_w"], True), _t(d["conv_b"], True)
    with _mesh():
        y = tseq.seq_halo_conv1d(x.view(b, S, t // S, dd), w, bias, "sp", seq_dim=2,
                                 shard_dim=1).reshape(b, t, dd)
    _close(y, jax_sp["conv/out0"])
    # the halo makes the sharded conv the unsharded one
    _close(y, tseq.seq_halo_conv1d(x, w, bias, None).detach().numpy(), atol=0)
    grads = torch.autograd.grad(y, [x, w, bias], torch.tensor(d["conv_r"]))
    for g, want in zip(grads, _grads(jax_sp, "conv")):
        _close(g, want)


@pytest.mark.parametrize("name", ["comb", "hops"])
def test_seq_scan_combines_match_the_sharded_reference(jax_sp, name):
    d = _inputs()
    fn = tseq.seq_scan_combine if name == "comb" else tseq.seq_scan_combine_hops
    decay = _t(d["comb_decay" if name == "comb" else "hops_decay"], True)
    state = _t(d["comb_state"], True)
    with _mesh():
        y = fn(decay, state, "sp", shard_dim=0)
    _close(y, jax_sp[f"{name}/out0"])
    for g, want in zip(torch.autograd.grad(y, [decay, state], torch.tensor(d["comb_r"])),
                       _grads(jax_sp, name)):
        _close(g, want)
    # shard 0 receives nothing; shard 1 receives shard 0's state
    assert not y[0].any()
    _close(y[1], d["comb_state"][0])


def test_the_two_combines_agree_on_a_moved_shard_dim():
    r = _rng(3)
    decay = torch.tensor(r.uniform(0.2, 1.0, (2, 5, 3)))
    state = torch.tensor(r.standard_normal((2, 5, 3, 4, 2)))
    with sharding_ctx(make_virtual_mesh({"sp": 5}, "cpu")):
        hops = tseq.seq_scan_combine_hops(decay, state, "sp", shard_dim=1)
        comb = tseq.seq_scan_combine(decay[..., None, None], state, "sp", shard_dim=1)
    torch.testing.assert_close(hops, comb, rtol=0, atol=1e-12)


@pytest.mark.parametrize("window", WINDOWS)
def test_swa_kv_halo_and_positions_match_the_sharded_reference(jax_sp, window):
    d = _inputs()
    b, t, hkv, dh = HALO_KV
    k, v = _t(d["kv_k"], True), _t(d["kv_v"], True)
    with _mesh():
        ke, ve, halo = tseq.swa_kv_halo(k.view(b, S, t // S, hkv, dh),
                                        v.view(b, S, t // S, hkv, dh), window, "sp", seq_dim=2,
                                        shard_dim=1)
        q_pos, k_pos = tseq.swa_position_ids(t // S, halo, "sp")
    assert halo == min(window, t // S)
    ke, ve = ke.reshape(b, -1, hkv, dh), ve.reshape(b, -1, hkv, dh)
    _close(ke, jax_sp[f"kv{window}/out0"], atol=0)
    _close(ve, jax_sp[f"kv{window}/out1"], atol=0)
    r = torch.tensor(d[f"kv_r{window}"])
    for g, want in zip(torch.autograd.grad((ke + 2 * ve) * r, [k, v], torch.ones_like(r)),
                       _grads(jax_sp, f"kv{window}")):
        _close(g, want)
    _close(q_pos, jax_sp[f"pos{window}/q"], atol=0)
    _close(k_pos, jax_sp[f"pos{window}/k"], atol=0)
    assert q_pos.dtype == k_pos.dtype == torch.int32


def test_sequence_functions_check_the_mesh_axis():
    x = torch.zeros((2, 4, 8, 3))
    w = torch.ones((4, 3))
    with pytest.raises(ValueError, match="not an axis of the active virtual mesh"):
        tseq.seq_halo_conv1d(x, w, None, "sp", seq_dim=2, shard_dim=1)
    with sharding_ctx(make_virtual_mesh({"sp": 2}, "cpu")):
        with pytest.raises(ValueError, match="which has 2"):
            tseq.seq_halo_conv1d(x, w, None, "sp", seq_dim=2, shard_dim=1)
        with pytest.raises(ValueError, match="shard_dim"):
            tseq.seq_halo_conv1d(x, w, None, "sp")
        with pytest.raises(ValueError, match="not an axis"):
            tseq.swa_position_ids(8, 2, "model")


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------


def _ssd_args(d, grad=True):
    return [_t(d[k], grad) for k in ("ssd_x", "ssd_dt", "ssd_A", "ssd_B", "ssd_C")]


@pytest.mark.parametrize("tag", ["ssd", "ssd_init"])
def test_ssd_chunk_scan_seq_axis_matches_the_sharded_reference(jax_sp, tag):
    """check_ssd.py's 4-shard scenario, chunk 8, forward and VJP; with a
    per-shard initial state the port's is (B, S, H, N, P), the reference's
    shard-local (B, H, N, P)."""
    d = _inputs()
    args = _ssd_args(d)
    init = _t(d["ssd_init"].transpose(1, 0, 2, 3, 4), True) if tag == "ssd_init" else None
    with _mesh():
        y, fin = tmamba._ssd_chunk_scan(*args, 8, seq_axis="sp", initial_state=init)
    assert fin.shape == (SSD[0], S, SSD[2], SSD[5], SSD[3])
    _close(y, jax_sp[f"{tag}/out0"])
    _close(fin.transpose(0, 1), jax_sp[f"{tag}/out1"])
    wrt = args + ([init] if init is not None else [])
    loss = (y * torch.tensor(d["ssd_ry"])).sum() + \
        (fin.transpose(0, 1) * torch.tensor(d["ssd_rf"])).sum()
    grads = list(torch.autograd.grad(loss, wrt))
    if init is not None:
        grads[-1] = grads[-1].transpose(0, 1)
    for g, want in zip(grads, _grads(jax_sp, tag)):
        _close(g, want, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_ssd_scan_op_seq_sharded_equals_the_plain_scan_and_the_unsharded_one():
    """The op (B5's plain version here) over the shards, its VJP through
    the cross-shard combine, against the plain ``_ssd_chunk_scan`` and,
    without an initial state, against the unsharded scan in fp64."""
    d = _inputs()
    args64 = [a.double().detach().requires_grad_(True) for a in _ssd_args(d)]
    with _mesh():
        y, fin = tmamba._sharded_scan(ssd_scan, *args64, 8, "sp")
        y_ref, fin_ref = tmamba._ssd_chunk_scan(*args64, 8, seq_axis="sp")
    y_un, fin_un = tmamba._ssd_chunk_scan(*args64, 8)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(fin, fin_ref, rtol=0, atol=0)
    torch.testing.assert_close(y, y_un, rtol=0, atol=1e-12)
    torch.testing.assert_close(fin[:, -1], fin_un, rtol=0, atol=1e-12)
    r = torch.tensor(d["ssd_ry"]).double()
    g = torch.autograd.grad((y * r).sum(), args64)
    g_un = torch.autograd.grad((y_un * r).sum(), args64)
    for a, b in zip(g, g_un):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


def test_ssd_initial_state_unsharded_matches_the_reference():
    """``_ssd_chunk_scan`` and the op with an ``initial_state`` (no mesh)
    against the reference's, grads to the state included."""
    d = _inputs()
    b, t, h, p, g, n = SSD
    init = d["ssd_init"][0]
    jargs = [jnp.asarray(d[k]) for k in ("ssd_x", "ssd_dt", "ssd_A", "ssd_B", "ssd_C")]

    def jloss(*a):
        y, fin = jmamba._ssd_chunk_scan(*a[:5], 16, initial_state=a[5])
        return jnp.sum(y * d["ssd_ry"]) + jnp.sum(fin * d["ssd_rf"][0]), (y, fin)

    jg, (jy, jfin) = jax.jit(jax.grad(jloss, argnums=tuple(range(6)), has_aux=True))(*jargs,
                                                                             jnp.asarray(init))
    for fn in (tmamba._ssd_chunk_scan, ssd_scan):
        args = _ssd_args(d) + [_t(init, True)]
        y, fin = fn(*args[:5], 16, initial_state=args[5])
        _close(y, np.asarray(jy))
        _close(fin, np.asarray(jfin))
        loss = (y * torch.tensor(d["ssd_ry"])).sum() + (fin * torch.tensor(d["ssd_rf"][0])).sum()
        for a, want in zip(torch.autograd.grad(loss, args), jg):
            _close(a, np.asarray(want), atol=1e-4 * max(1.0, np.abs(np.asarray(want)).max()))


# ---------------------------------------------------------------------------
# mamba_block and apply_lm
# ---------------------------------------------------------------------------


def _jax_lm_params():
    return jlm.init_lm(jax.random.PRNGKey(0), jmcfg.reduced())


def _slow_decay(mp: dict, d: dict) -> dict:
    """A Mamba2 layer's params with ``A_log`` and ``dt_bias`` from the
    inputs: decays slow enough that a shard's state reaches the next shard
    (at the init's zeros a 64-token shard decays by ~e^-45, and the handoff
    is below fp32's rounding)."""
    return {**mp, "A_log": d["a_log"].reshape(mp["A_log"].shape[-1:]) + 0 * mp["A_log"],
            "dt_bias": d["dt_bias"].reshape(mp["dt_bias"].shape[-1:]) + 0 * mp["dt_bias"]}


def _fp64_bars(port32, ref32, exact64):
    """Per output: ATOL, or GRAD_FLOOR_FACTOR x the larger of the two
    packages' unsharded fp32 distances from the fp64 run (the fp64 rule,
    with the reference's own rounding beside the port's)."""
    return [max(ATOL, GRAD_FLOOR_FACTOR * max(float((a.double() - e).abs().max()),
                                              float(np.abs(r - e.detach().numpy()).max())))
            for a, r, e in zip(port32, ref32, exact64)]


def test_mamba_block_seq_axis_matches_the_reference_sharded_and_unsharded(jax_sp):
    d = _inputs()
    tcfg = treg.load_config("mamba2-780m", reduced=True)
    jp = _slow_decay(jax.tree.map(lambda a: np.asarray(a[0]),
                                  _jax_lm_params()["segments"][0][0]["mamba"]), d)
    assert list(jp) == sorted(jp)          # the reference's leaves: sorted keys
    r = torch.tensor(d["mamba_r"])

    def run(dtype, axis):
        p = {k: _t(v).to(dtype).requires_grad_(True) for k, v in jp.items()}
        x = _t(d["mamba_u"]).to(dtype).requires_grad_(True)
        with _mesh():
            y = tmamba.mamba_block(p, x, tcfg, seq_axis=axis)
        return [y] + list(torch.autograd.grad(y, [x] + list(p.values()), r.to(dtype)))

    got = run(torch.float32, "sp")
    exact = run(torch.float64, None)
    sharded64 = run(torch.float64, "sp")
    for a, e in zip(sharded64, exact):
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-10)
    ref = {tag: _outs(jax_sp, f"block_{tag}") + _grads(jax_sp, f"block_{tag}")
           for tag in ("sharded", "unsharded")}
    bars = _fp64_bars(run(torch.float32, None), ref["unsharded"], exact)
    for tag in ("sharded", "unsharded"):
        for g, want, bar in zip(got, ref[tag], bars):
            _close(g, want, atol=bar)
    # the handoff matters here: dropping it moves the output far past the bar
    y_alone = tmamba.mamba_block({k: _t(v) for k, v in jp.items()},
                                 _t(d["mamba_u"]).view(2 * S, MAMBA_T // S, -1), tcfg)
    assert float((y_alone.reshape(got[0].shape) - got[0]).abs().max()) > 100 * bars[0]


def _lm_params(d):
    jparams = _jax_lm_params()
    seg = jparams["segments"][0][0]
    jparams["segments"][0][0] = {**seg, "mamba": _slow_decay(seg["mamba"], d)}
    return jparams


def test_apply_lm_seq_axis_matches_the_reference_sharded_and_unsharded(jax_sp):
    d = _inputs()
    tcfg = treg.load_config("mamba2-780m", reduced=True)
    np_params = jax.tree.map(np.asarray, _lm_params(d))
    tokens, labels = torch.tensor(d["lm_tokens"]), torch.tensor(d["lm_labels"])

    def run(dtype, axis, remat="none"):
        tp = lm_params_from_jax(jax.tree.map(lambda a: a.astype(
            np.float64 if dtype == torch.float64 else a.dtype), np_params), "cpu")
        leaves = []                        # in the reference's flattening order
        map_with_path(lambda path, a: leaves.append(a.requires_grad_(True)), tp)
        with _mesh():
            hidden = tlm.apply_lm(tp, tokens, tcfg, seq_axis=axis, remat=remat)
            loss = tlm.chunked_cross_entropy(hidden.to(dtype), tlm.lm_head_weight(tp, tcfg),
                                             labels)
        # the backward (and remat's recomputation) outside the mesh's context
        return [hidden, loss] + list(torch.autograd.grad(loss, leaves))

    got = run(torch.float32, "sp", remat="full")
    exact = run(torch.float64, None)
    ref = {tag: _outs(jax_sp, f"lm_{tag}") + _grads(jax_sp, f"lm_{tag}")
           for tag in ("sharded", "unsharded")}
    assert len(ref["sharded"]) == len(got)
    bars = _fp64_bars(run(torch.float32, None), ref["unsharded"], exact)
    for tag in ("sharded", "unsharded"):
        for g, want, bar in zip(got, ref[tag], bars):
            _close(g, want, atol=bar)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_apply_lm_seq_axis_runs_under_every_remat(remat):
    tcfg = treg.load_config("mamba2-780m", reduced=True)
    tp = treg.bundle_from_cfg(tcfg, "cpu").init(0)
    for a in tree_leaves(tp):
        a.requires_grad_(True)
    tokens = torch.tensor(_inputs()["lm_tokens"])
    with _mesh():
        h = tlm.apply_lm(tp, tokens, tcfg, seq_axis="sp", remat=remat)
        g = torch.autograd.grad(h.square().sum(), tree_leaves(tp))
    with _mesh():
        h0 = tlm.apply_lm(tp, tokens, tcfg, seq_axis="sp")
        g0 = torch.autograd.grad(h0.square().sum(), tree_leaves(tp))
    assert torch.equal(h, h0) and all(torch.equal(a, b) for a, b in zip(g, g0))


# ---------------------------------------------------------------------------
# the sequence-sharded decode
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _qwen_attn_params() -> dict:
    jcfg = jreg.load_config("qwen2-7b", reduced=True)
    return jax.tree.map(lambda a: np.asarray(a[0]), jlm.init_lm(jax.random.PRNGKey(0), jcfg)
                        ["segments"][0][0]["attn"])


DECODE_CASES = {
    # name: (window, cache rows, per-slot lengths)
    "full": (None, 16, [3, 15, 9]),
    "ring": (8, 8, [2, 13, 21]),       # slot 0 has never-written ring slots
}


@pytest.mark.parametrize("mesh_axes", [{"model": 4}, {"model": 3}, None])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_attention_seq_sharded_matches_the_reference(case, mesh_axes):
    """On 4 shards of the ``seq_shard`` axis, and on the 1-shard fallbacks
    (3 does not divide the rows; no mesh)."""
    window, rows, lengths = DECODE_CASES[case]
    jcfg = jreg.load_config("qwen2-7b", reduced=True)
    tcfg = treg.load_config("qwen2-7b", reduced=True)
    jp = _qwen_attn_params()
    tp = {k: torch.tensor(v) for k, v in jp.items()}
    r = _rng(7)
    b = len(lengths)
    k = r.standard_normal((b, rows, jcfg.n_kv_heads, jcfg.resolved_head_dim)).astype(np.float32)
    v = r.standard_normal(k.shape).astype(np.float32)
    x = r.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    want, wc = jax.jit(lambda x, c: jattn.decode_attention(
        jp, x, c, jcfg, window=window, seq_sharded=True))(
        jnp.asarray(x), jattn.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))
    cache = tattn.KVCache(torch.tensor(k), torch.tensor(v), torch.tensor(lens))
    ctx = sharding_ctx(None if mesh_axes is None else make_virtual_mesh(mesh_axes, "cpu"))
    with ctx:
        got, _ = tattn.decode_attention(tp, torch.tensor(x), cache, tcfg, window=window,
                                        seq_sharded=True)
    _close(got, np.asarray(want))
    _close(cache.k, np.asarray(wc.k))
    plain = tattn.decode_attention(tp, torch.tensor(x), tattn.KVCache(
        torch.tensor(k), torch.tensor(v), torch.tensor(lens)), tcfg, window=window)[0]
    _close(got, plain.numpy())


def test_decode_attend_seq_sharded_masks_unwritten_ring_slots():
    """Dropping ``kpos >= 0`` from ``valid`` lets a never-written slot's
    zero key into the softmax: the check the planted fault of
    chip_smoke.py's phase 25(c) must fail."""
    r = _rng(11)
    q = torch.tensor(r.standard_normal((1, 1, 4, 8)))
    k = torch.tensor(r.standard_normal((1, 8, 2, 8)))
    v = torch.tensor(r.standard_normal((1, 8, 2, 8)))
    row = torch.arange(8)[None]
    pos = torch.tensor([[2]])
    kpos = torch.where(row <= 2, row, row - 8)
    valid = (kpos <= pos) & (kpos >= 0)
    with sharding_ctx(make_virtual_mesh({"model": 2}, "cpu")):
        good = tattn.decode_attend_seq_sharded(q, k, v, pos, kpos, valid, 8)
        bad = tattn.decode_attend_seq_sharded(q, k, v, pos, kpos, kpos <= pos, 8)
    want = tattn._sdpa(q, k[:, :3], v[:, :3], pos, kpos[:, :3], causal=True, window=8)
    torch.testing.assert_close(good, want, rtol=0, atol=1e-12)
    assert (bad - good).abs().max() > 1e-2


# ---------------------------------------------------------------------------
# C.17: the reference's sharded apply_lm on attention and MoE layers
# ---------------------------------------------------------------------------


_JAX_C17 = r'''
import dataclasses
import json
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P

from repro.models import lm as L
from repro.models import mlp as MLP
from repro.models import registry as R

mesh = jax.make_mesh((2,), ("sp",), axis_types=(AxisType.Auto,))
SEQ = P(None, "sp")
out = {}
for name in ("jamba-v0.1-52b", "mamba2-780m"):
    cfg = R.load_config(name, reduced=True)
    params = L.init_lm(jax.random.PRNGKey(0), cfg)
    tokens = jnp.asarray(np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)), jnp.int32)
    full = L.apply_lm(params, tokens, cfg)
    sh = jax.jit(jax.shard_map(lambda t: L.apply_lm(params, t, cfg, seq_axis="sp"), mesh=mesh,
                               in_specs=(SEQ,), out_specs=SEQ, check_vma=False))(tokens)
    err = np.abs(np.asarray(sh) - np.asarray(full))
    out[name] = {"first": float(err[:, :32].max()), "second": float(err[:, 32:].max()),
                 "magnitude": float(np.abs(np.asarray(full)).max())}

# the MoE dispatch per shard against the unsharded one, past the dropless floor
cfg = R.load_config("mixtral-8x22b", reduced=True)
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
mp = jax.tree.map(lambda a: a[0], L.init_lm(jax.random.PRNGKey(0), cfg)["segments"][0][0]["moe"])
x = jnp.asarray(np.random.default_rng(1).standard_normal((2, 512, cfg.d_model)), jnp.float32)
full = MLP.moe(mp, x, cfg)
sh = jax.jit(jax.shard_map(lambda u: MLP.moe(mp, u, cfg), mesh=mesh, in_specs=(SEQ,),
                           out_specs=SEQ, check_vma=False))(x)
m = cfg.moe


def kept(xs):
    n = xs.shape[0] * xs.shape[1]
    _, topi, _ = MLP._route(mp["router"], xs.reshape(n, -1), m)
    cap = max(1, int(n * m.top_k * m.capacity_factor) // m.n_experts)
    oh = jax.nn.one_hot(topi, m.n_experts, dtype=jnp.int32).reshape(n * m.top_k, -1)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - oh) * oh, axis=-1)
    return np.asarray(pos < cap).reshape(xs.shape[0], xs.shape[1], m.top_k)


keep_full = kept(x)
keep_sh = np.concatenate([kept(x[:, :256]), kept(x[:, 256:])], axis=1)
out["moe"] = {"max_abs_diff": float(np.abs(np.asarray(sh) - np.asarray(full)).max()),
              "dropped_full": int((~keep_full).sum()), "dropped_sharded": int((~keep_sh).sum()),
              "differ": int((keep_full != keep_sh).sum())}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_c17():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _JAX_C17], env=env, check=True, timeout=600,
                       capture_output=True, text=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_c17_reference_seq_axis_attends_within_the_shard(jax_c17):
    """ROADMAP C.17: under ``shard_map`` on 2 devices the reference's
    ``apply_lm(seq_axis=)`` passes the axis to the Mamba2 mixers alone, and
    builds positions from the shard's own length, so each attention layer
    attends within its shard at positions that restart at 0: Jamba's first
    half agrees with the unsharded run, its second half does not; a model
    of Mamba2 layers alone agrees in both halves."""
    jam, mam = jax_c17["jamba-v0.1-52b"], jax_c17["mamba2-780m"]
    assert jam["first"] < 1e-4
    assert jam["second"] > 0.1 and jam["second"] > 0.05 * jam["magnitude"]
    assert mam["first"] < 1e-4 and mam["second"] < 1e-4


def test_c17_reference_moe_per_shard_dispatch_drops_other_assignments(jax_c17):
    """The reference's MoE under the same sharding dispatches each shard's
    tokens at the shard's capacity: at a capacity that drops (reduced
    Mixtral at capacity factor 0.5, 1024 tokens), other assignments drop
    than in its unsharded run, and the outputs differ."""
    moe = jax_c17["moe"]
    assert moe["dropped_full"] > 0 and moe["dropped_sharded"] > 0 and moe["differ"] > 0
    assert moe["max_abs_diff"] > 1e-3


@pytest.mark.parametrize("name", ["qwen2-7b", "jamba-v0.1-52b", "mixtral-8x22b",
                                  "deepseek-v3-671b", "qwen2-vl-2b"])
def test_port_refuses_seq_axis_on_attention_and_moe_layers_c17(name):
    cfg = treg.load_config(name, reduced=True)
    p = treg.bundle_from_cfg(cfg, "cpu").init(0)
    first = next(i for i in range(cfg.n_layers)
                 if tlm.layer_kind(cfg, i).mixer == "attn" or tlm.layer_kind(cfg, i).moe)
    with sharding_ctx(make_virtual_mesh({"sp": 2}, "cpu")):
        with pytest.raises(ValueError, match=rf"layer {first} is .*C\.17"):
            tlm.apply_lm(p, torch.zeros((1, 32), dtype=torch.int32), cfg, seq_axis="sp")


def test_mixer_mesh_axis_must_exist():
    cfg = treg.load_config("mamba2-780m", reduced=True)
    p = treg.bundle_from_cfg(cfg, "cpu").init(0)
    with pytest.raises(ValueError, match="not an axis of the active virtual mesh"):
        tlm.apply_lm(p, torch.zeros((1, 32), dtype=torch.int32), cfg, seq_axis="sp")
    with sharding_ctx(make_virtual_mesh({"sp": 3}, "cpu")):
        with pytest.raises(ValueError, match="does not split"):
            tlm.apply_lm(p, torch.zeros((1, 32), dtype=torch.int32), cfg, seq_axis="sp")
