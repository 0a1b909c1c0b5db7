"""The port's cell grid and abstract params against the reference's:
``configs.base.SHAPES``, ``models.registry.period_counts`` /
``cell_supported`` / ``all_cells`` for the 10 architectures x 4 shapes,
``abstract_params`` (``meta`` tensors, nothing drawn) and its
``analysis.roofline.count_params_cfg``, total and active, against the
reference's count of its ``jax.eval_shape``'d params, and the production and
local meshes.  The production meshes need 512 fake JAX devices, so the
reference's are made in a subprocess that sets ``XLA_FLAGS`` before it
imports jax.  Whole file ~25 s on one worker."""
import dataclasses
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.analysis import roofline as ref_roofline
from repro.configs import base as ref_base
from repro.models import registry as ref_registry
from repro_torch.analysis.roofline import count_params_cfg
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import lm as lm_mod
from repro_torch.models import registry
from repro_torch.optim.optimizers import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(ref_registry.ARCH_IDS)


def test_shapes_are_the_references():
    assert list(SHAPES) == list(ref_base.SHAPES)
    for k in SHAPES:
        assert dataclasses.astuple(SHAPES[k]) == dataclasses.astuple(ref_base.SHAPES[k])


def test_arch_ids_are_the_references():
    assert registry.ARCH_IDS == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_period_counts_and_cells_match_the_reference(arch, reduced):
    cfg, ref_cfg = registry.load_config(arch, reduced), ref_registry.load_config(arch, reduced)
    assert registry.period_counts(cfg) == ref_registry.period_counts(ref_cfg)
    assert cfg.sub_quadratic() == ref_cfg.sub_quadratic()
    for name in SHAPES:
        assert registry.cell_supported(cfg, SHAPES[name]) == \
            ref_registry.cell_supported(ref_cfg, ref_base.SHAPES[name]), name
    for n in (1, 2):
        assert registry.with_depth(cfg, n).n_layers == ref_registry.with_depth(ref_cfg, n).n_layers
        assert registry.with_depth(cfg, n).n_encoder_layers == \
            ref_registry.with_depth(ref_cfg, n).n_encoder_layers


@pytest.mark.parametrize("reduced", [False, True])
def test_all_cells_is_the_references_grid(reduced):
    got = [(a, dataclasses.astuple(s), ok, why) for a, s, ok, why in registry.all_cells(reduced)]
    want = [(a, dataclasses.astuple(s), ok, why)
            for a, s, ok, why in ref_registry.all_cells(reduced)]
    assert got == want
    assert len(got) == 40
    # the configs with a full-attention layer and no SSM skip the 500k-token decode
    assert sorted(a for a, s, ok, _ in got if not ok) == sorted(
        ["codeqwen1.5-7b", "stablelm-1.6b", "qwen2-7b", "command-r-35b", "deepseek-v3-671b",
         "qwen2-vl-2b", "whisper-medium"])


def _ref_counts(arch: str) -> tuple[int, int]:
    bundle = ref_registry.get_arch(arch)
    return ref_roofline.count_params_cfg(bundle.abstract_params(), bundle.cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_of_abstract_params_match_the_reference(arch):
    """Full width and depth: the bundle's ``abstract_params`` (and the LM
    module's own) on the ``meta`` device, counted as the reference counts
    its ``jax.eval_shape``'d tree - DeepSeek-V3's 671B included."""
    cfg = registry.load_config(arch)
    bundle = registry.bundle_from_cfg(cfg, "cpu")
    params = bundle.abstract_params()
    assert all(x.device.type == "meta" for x in tree_leaves(params))
    got = count_params_cfg(params, cfg)
    assert got == _ref_counts(arch)
    if not cfg.encoder_decoder:
        assert count_params_cfg(lm_mod.abstract_params(cfg), cfg) == got


def test_deepseek_abstract_params_take_seconds_and_no_memory():
    cfg = registry.load_config("deepseek-v3-671b")
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.monotonic()
    params = lm_mod.abstract_params(cfg)
    took = time.monotonic() - t0
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0) * 1024
    total, active = count_params_cfg(params, cfg)
    assert total > 6.7e11 and active < total
    assert took < 60, took
    assert grown < 2**30, grown          # 1.3 TB of bf16 params if anything were allocated


def test_tiled_cnn_abstract_params_match_the_reference():
    from repro.models.yolo import make_yolo_tiled_arch as ref_arch
    from repro_torch.models.yolo import make_yolo_tiled_arch

    arch = make_yolo_tiled_arch((32, 32), 4, 2, 2, device="cpu")
    got = arch.abstract_params()
    want = ref_arch((32, 32), 4, 2, 2, mesh=_one_device_tile_mesh()).abstract_params()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert g[k].device.type == "meta"
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            assert str(g[k].dtype).replace("torch.", "") == str(w[k].dtype), k


def _one_device_tile_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("th", "tw"))


_JAX_MESHES = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.launch.mesh import make_production_mesh
out = {}
for multi in (False, True):
    m = make_production_mesh(multi_pod=multi)
    out[str(multi)] = [list(m.axis_names), [int(m.shape[a]) for a in m.axis_names]]
print(json.dumps(out))
"""


def test_production_and_local_meshes_match_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_MESHES], env=env, check=True, timeout=600,
                       capture_output=True, text=True)
    want = json.loads(r.stdout.strip().splitlines()[-1])
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        assert [list(mesh.shape), list(mesh.shape.values())] == want[str(multi)]
        assert mesh.device == torch.device("cpu")
    from repro.launch.mesh import make_local_mesh as ref_local

    ref = ref_local()
    local = make_local_mesh(device="cpu")
    assert list(local.shape) == list(ref.axis_names)
    assert list(local.shape.values()) == [int(ref.shape[a]) for a in ref.axis_names]
    assert make_local_mesh(("a", "b"), device="cpu").shape == {"a": 1, "b": 1}


def test_meshes_raise_for_a_card_that_is_not_there():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        make_local_mesh()
