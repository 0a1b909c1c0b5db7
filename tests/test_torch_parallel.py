"""The port's ``parallel/api.py`` and ``parallel/sharding.py`` against the
reference's, on the CPU.

The pure resolution (``logical_spec`` and every function built on it) runs
in this process: the reference's ``_resolve`` reads only its active mesh's
``shape``, so a stand-in with that mapping is installed in its
``_ACTIVE.mesh`` (and its ``NamedSharding`` swapped for the bare spec) by
``monkeypatch`` - the JAX package is not edited - while the port runs on a
``VirtualMesh`` of the same axes:
- ``logical_spec`` entry for entry, every layout, a grid of logical names,
  shapes and mesh shapes;
- ``param_logical_tree`` and ``param_shardings`` leaf for leaf for the ten
  reduced archs; ``state_shardings`` (AdamW; adafactor's factored ``vr`` /
  ``vc``), ``batch_shardings`` and ``cache_shardings`` (both
  ``seq_sharded``);
- the MoE dispatch under a 2x2 mesh: the reference under ``sharding_ctx`` on
  4 fake devices (a subprocess), the same outputs and dropped assignments;
- ``constrain``, ``gather_for_compute``, ``named_sharding`` and the
  context's restore and re-entry.
~40 s on one worker.
"""
import itertools
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.mlp as jmlp
import repro.parallel.api as japi
import repro.parallel.sharding as jsh
import repro_torch.models.mlp as tmlp
import repro_torch.parallel.api as tapi
import repro_torch.parallel.sharding as tsh
from repro.compat import keystr_slash
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ShapeConfig as JShape
from repro.models import registry as jreg
from repro.optim import optimizers as jopt
from repro_torch.configs.base import ModelConfig, MoEConfig, ParallelConfig, ShapeConfig
from repro_torch.interop import lm_params_from_jax
from repro_torch.launch.mesh import VirtualMesh, make_virtual_mesh
from repro_torch.models import registry as treg
from repro_torch.optim import optimizers as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [{"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 2}, {"model": 3},
          {"data": 4}]
NAMES = [None] + sorted(tapi.DEFAULT_RULES)
DIMS = (1, 2, 3, 4, 6, 8, 12, 16)


class _StandIn:
    """What the reference's ``_resolve`` reads of a mesh: ``shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


@pytest.fixture
def both(monkeypatch):
    """``both(mesh_axes, rules)``: the reference's active mesh and rules set
    to a stand-in of ``mesh_axes`` (``None``: no mesh), and the port's
    context entered with a ``VirtualMesh`` of the same axes."""
    stack = []

    def enter(axes, rules=None):
        monkeypatch.setattr(japi._ACTIVE, "mesh", None if axes is None else _StandIn(axes))
        monkeypatch.setattr(japi._ACTIVE, "rules", {**japi.DEFAULT_RULES, **(rules or {})})
        monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: tuple(spec))
        ctx = tapi.sharding_ctx(None if axes is None else make_virtual_mesh(axes, "cpu"), rules)
        ctx.__enter__()
        stack.append(ctx)

    yield enter
    for ctx in reversed(stack):
        ctx.__exit__(None, None, None)


def _is_spec_leaf(x):
    return x is None or (isinstance(x, tuple) and not hasattr(x, "_fields"))


def _jax_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec_leaf)
    return {keystr_slash(p): (None if v is None else tuple(v)) for p, v in flat}


def _port_flat(tree, prefix="") -> dict:
    def sub(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _port_flat(tree[key], sub(key)).items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: v for f in tree._fields for k, v in _port_flat(getattr(tree, f), sub(f)).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree) for k, v in _port_flat(x, sub(i)).items()}
    return {prefix: tree}


LM_ARCHS = ["codeqwen1.5-7b", "command-r-35b", "deepseek-v3-671b", "jamba-v0.1-52b",
            "mamba2-780m", "mixtral-8x22b", "qwen2-7b", "qwen2-vl-2b", "stablelm-1.6b",
            "whisper-medium"]


def _params(name):
    """(the reference's param shapes, the port's params) of a reduced arch."""
    jarch = jreg.get_arch(name, reduced=True)
    jp = jax.eval_shape(jarch.init, jax.random.PRNGKey(0))
    tp = treg.get_arch(name, reduced=True, device="cpu").init(0)
    return jp, tp


# ---------------------------------------------------------------------------
# api.py
# ---------------------------------------------------------------------------


def test_the_tables_are_the_references():
    assert tapi.DEFAULT_RULES == japi.DEFAULT_RULES
    assert tapi.LAYOUTS == japi.LAYOUTS
    for layout in japi.LAYOUTS:
        assert tapi.layout_rules(layout) == japi.layout_rules(layout)
    assert tsh._RULES == jsh._RULES
    # ParallelConfig: the fields the port reads, at the reference's defaults;
    # the mesh fields, which nothing in the port reads, are left out
    from repro.configs.base import ParallelConfig as JParallel
    want = {f: getattr(JParallel(), f) for f in JParallel.__dataclass_fields__}
    fields = {f: getattr(ParallelConfig(), f) for f in ParallelConfig.__dataclass_fields__}
    assert fields == {f: want[f] for f in ("remat", "grad_accum", "unroll", "ce_chunk")}
    assert set(want) - set(fields) == {"fsdp_axis", "tp_axis", "dp_axes", "seq_shard_cache",
                                       "expert_axis", "shard_moe_tokens", "layout"}


@pytest.mark.parametrize("axes", MESHES + [None], ids=lambda a: str(a))
@pytest.mark.parametrize("layout", sorted(japi.LAYOUTS))
def test_logical_spec_matches_the_reference(both, layout, axes):
    both(axes, japi.layout_rules(layout))
    rng = np.random.default_rng(len(layout) + (0 if axes is None else len(axes)))
    cases = [(a, b) for a in NAMES for b in NAMES]
    cases += [tuple(rng.choice(np.array(NAMES, dtype=object), size=rng.integers(1, 5)))
              for _ in range(200)]
    for logical in cases:
        logical = tuple(logical)
        for shape in itertools.islice(itertools.product(DIMS, repeat=len(logical)), 0, None,
                                      max(1, len(DIMS) ** len(logical) // 24)):
            want = tuple(japi.logical_spec(logical, shape))
            assert tapi.logical_spec(logical, shape) == want, (logical, shape)
            assert tapi.named_sharding(logical, shape) == (None if axes is None else want)
    for a in ("data", "model", "pod", ("pod", "data"), None, "absent"):
        assert tapi.axis_size(a) == japi.axis_size(a)


@pytest.mark.parametrize("name", LM_ARCHS)
def test_param_logical_tree_and_shardings_match_the_reference(both, name):
    jp, tp = _params(name)
    want = _jax_flat(jsh.param_logical_tree(jp))
    assert _port_flat(tsh.param_logical_tree(tp)) == want
    assert len(want) == len(_port_flat(tp))
    both({"data": 2, "model": 4})
    assert _port_flat(tsh.param_shardings(tp)) == _jax_flat(jsh.param_shardings(jp))


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("name", ["qwen2-7b", "mixtral-8x22b", "mamba2-780m"])
def test_state_shardings_match_the_reference(both, name, opt):
    jp, tp = _params(name)
    js = jax.eval_shape(getattr(jopt, opt)().init, jp)
    ts = getattr(topt, opt)().init(tp)
    both({"data": 2, "model": 4})
    want = _jax_flat(jsh.state_shardings(js, jp))
    assert _port_flat(tsh.state_shardings(ts, tp)) == want


def test_state_shardings_drop_the_factored_entry_as_the_reference(both):
    """Widths of 128 and more factor adafactor's second moment: ``vr``
    drops the last dim's entry, ``vc`` the one before it."""
    shapes = {"embed": (256, 128), "lm_head": (256, 128),
              "segments": [[{"mlp": {"w_up": (2, 128, 256), "w_down": (2, 256, 128)},
                             "moe": {"w_gate": (2, 4, 128, 256)}}]]}
    jp = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
                      is_leaf=lambda x: isinstance(x, tuple))
    tp = jax.tree.map(lambda s: torch.zeros(s), shapes, is_leaf=lambda x: isinstance(x, tuple))
    js = jax.eval_shape(jopt.adafactor().init, jp)
    ts = topt.adafactor().init(tp)
    both({"data": 2, "model": 4})
    want = _jax_flat(jsh.state_shardings(js, jp))
    assert any(k.endswith("vr") for k in want) and any(k.endswith("vc") for k in want)
    assert _port_flat(tsh.state_shardings(ts, tp)) == want


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("name", [a for a in LM_ARCHS if a != "whisper-medium"])
def test_cache_and_batch_shardings_match_the_reference(both, name, seq_sharded):
    """A Mamba2 layer's ``length`` is a scalar in the reference and one per
    slot in the port (``MambaState``), so its spec is held to the rule of
    its own rank; every other leaf as the reference's."""
    jarch = jreg.get_arch(name, reduced=True)
    tarch = treg.get_arch(name, reduced=True, device="cpu")
    jc = jax.eval_shape(lambda: jarch.make_caches(4, 16))
    tc = tarch.cache_specs(4, 16)
    both({"data": 2, "model": 4})
    want = _jax_flat(jsh.cache_shardings(jc, seq_sharded=seq_sharded))
    got = _port_flat(tsh.cache_shardings(tc, seq_sharded=seq_sharded))
    assert got.keys() == want.keys()
    for k in want:
        if k.endswith("/length"):
            assert want[k] == () and got[k] == ("data",)
        else:
            assert got[k] == want[k], k
    jb = jarch.input_specs(JShape("t", 32, 8, "train"))
    tb = tarch.input_specs(ShapeConfig("t", 32, 8, "train"))
    assert tsh.batch_shardings(tb) == jsh.batch_shardings(jb)


def test_off_mesh_everything_resolves_to_none():
    tp = treg.get_arch("qwen2-7b", reduced=True, device="cpu").init(0)
    assert all(v is None for v in _port_flat(tsh.param_shardings(tp)).values())
    assert tapi.named_sharding(("batch",), (8,)) is None
    x = torch.zeros((2, 3))
    assert tapi.constrain(x, "batch") is x          # no rank check without a mesh
    assert tapi.gather_for_compute(tp) is tp


def test_constrain_checks_the_rank_under_a_mesh_and_returns_x():
    x = torch.zeros((4, 6))
    with tapi.sharding_ctx(make_virtual_mesh({"data": 2}, "cpu")):
        assert tapi.constrain(x, "batch", None) is x
        with pytest.raises(ValueError, match="rank"):
            tapi.constrain(x, "batch")
        assert tapi.gather_for_compute({"a": x})["a"] is x


def test_sharding_ctx_restores_and_re_enters_on_another_thread():
    mesh = make_virtual_mesh({"sp": 4, "model": 2}, "cpu")
    assert isinstance(mesh, VirtualMesh) and list(mesh.shape.items()) == [("sp", 4), ("model", 2)]
    with pytest.raises(TypeError, match="VirtualMesh"):
        with tapi.sharding_ctx(_StandIn({"sp": 4})):
            pass
    with tapi.sharding_ctx(mesh, {"seq_shard": "sp"}):
        enter = tapi.captured_ctx()
        assert tapi.active_mesh() is mesh and tapi.axis_size("sp") == 4
    assert tapi.active_mesh() is None and tapi._ACTIVE.rules == tapi.DEFAULT_RULES
    seen = []

    def other():
        seen.append(tapi.active_mesh())
        with enter():
            seen.append((tapi.active_mesh(), tapi._ACTIVE.rules["seq_shard"]))

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    assert seen == [None, (mesh, "sp")]


# ---------------------------------------------------------------------------
# the MoE dispatch under a 2x2 mesh
# ---------------------------------------------------------------------------

MOE_X = (4, 256, 16)         # 2 groups of 512 tokens: 1024 assignments each


def _moe_cfgs():
    kw = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=0,
              vocab=32, dtype="float32", param_dtype="float32")
    moe = dict(n_experts=4, top_k=2, d_ff_expert=32, n_shared_experts=0, d_ff_shared=32,
               capacity_factor=0.25)
    return JModelConfig(moe=JMoEConfig(**moe), **kw), ModelConfig(moe=MoEConfig(**moe), **kw)


_JAX_MOE = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import repro.models.mlp as jmlp
from repro.configs.base import ModelConfig, MoEConfig
from repro.parallel.api import sharding_ctx

kw = dict(name="t", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2, d_ff=0,
          vocab=32, dtype="float32", param_dtype="float32")
cfg = ModelConfig(moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared_experts=0,
                                d_ff_shared=32, capacity_factor=0.25), **kw)
jp = jmlp.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
x = jnp.asarray(np.load(sys.argv[1])["x"])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
with sharding_ctx(mesh):
    y = jax.jit(lambda u: jmlp.moe(jp, u, cfg))(x)
    g, ep = jmlp._dispatch_groups(x.shape[0]), jmlp._expert_shards()
m = cfg.moe
n = x.shape[0] * x.shape[1] // g
_, topi, _ = jmlp._route(jp["router"], x.reshape(g, n, -1), m)
cap = max(1, int(n * m.top_k * m.capacity_factor) // m.n_experts)
oh = jax.nn.one_hot(topi, m.n_experts, dtype=jnp.int32).reshape(g, n * m.top_k, -1)
pos = jnp.sum((jnp.cumsum(oh, axis=1) - oh) * oh, axis=-1)
np.savez(sys.argv[2], y=np.asarray(y), keep=np.asarray(pos < cap).reshape(g, n, m.top_k),
         groups=g, shards=ep)
'''


def test_moe_under_a_2x2_mesh_matches_the_reference_and_drops_the_same(tmp_path):
    jcfg, tcfg = _moe_cfgs()
    x = np.random.default_rng(5).standard_normal(MOE_X).astype(np.float32)
    np.savez(tmp_path / "in.npz", x=x)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    subprocess.run([sys.executable, "-c", _JAX_MOE, tmp_path / "in.npz", tmp_path / "out.npz"],
                   env=env, check=True, timeout=600)
    ref = np.load(tmp_path / "out.npz")
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jmlp.init_moe(
        jax.random.PRNGKey(0), jcfg, jnp.float32)), "cpu")
    with tapi.sharding_ctx(make_virtual_mesh({"data": 2, "model": 2}, "cpu")):
        g, ep = tmlp._dispatch_groups(MOE_X[0]), tmlp._expert_shards()
        y = tmlp.moe(tp, torch.from_numpy(x), tcfg)
    assert (g, ep) == (int(ref["groups"]), int(ref["shards"])) == (2, 2)
    np.testing.assert_allclose(y.numpy(), ref["y"], atol=1e-5, rtol=0)
    n = MOE_X[0] * MOE_X[1] // g
    _, topi, _ = tmlp._route(tp["router"], torch.from_numpy(x).reshape(g, n, -1), tcfg.moe)
    keep = tmlp.queue_positions(topi, 4, tmlp.moe_capacity(n, tcfg.moe))[1].numpy()
    np.testing.assert_array_equal(keep, ref["keep"])
    assert 0 < keep.sum() < keep.size
    # one group (no mesh) drops other assignments and gives other outputs
    assert not np.allclose(tmlp.moe(tp, torch.from_numpy(x), tcfg).numpy(), ref["y"], atol=1e-3)
