"""The port's dry run (``launch/dryrun.py``) against the reference's, and
the train launcher's ``--mesh``.

- ``lower_train`` -> ``_compile_stats`` on a one-device mesh: the argument
  bytes equal the reference's ``memory_analysis().argument_size_in_bytes``
  for the same reduced cell (the reference's dry run sets ``XLA_FLAGS`` at
  import, so its lowerings run in one subprocess that initialises JAX on
  one device first), and equal the bytes of a live state the port builds
  for real plus the batch - the check ``chip_smoke.py``'s phase 28(a) makes
  on the card, with its planted fault.
- the CLI: the reference's keys, a skipped cell, ``--list``, a failing cell
  recorded as ``"error"``.
- ``python -m repro_torch.launch.train --mesh single|multi|local``.

Whole file ~40 s on one worker (the JAX subprocess ~20 s of it);
``test_torch_dryrun_depth.py`` holds the depth-scaling check."""
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import ParallelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import registry
from repro_torch.models.registry import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = ShapeConfig("t", 64, 4, "train")
MEM_ARCHS = ["qwen2-7b", "mixtral-8x22b", "deepseek-v3-671b"]      # dense, MoE, MLA + MoE

_JAX_ARGUMENT_BYTES = r"""
import json, sys
import jax
jax.devices()               # one CPU device, before the dry run sets XLA_FLAGS
import numpy as np
from jax.sharding import Mesh
from repro.configs.base import ShapeConfig
from repro.launch import dryrun as D
from repro.models.registry import load_config
mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
out = {}
for arch in sys.argv[1:]:
    low = D.lower_train(load_config(arch, reduced=True), ShapeConfig("t", 64, 4, "train"), mesh,
                        unroll=False)
    out[arch] = int(low.compile().memory_analysis().argument_size_in_bytes)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_argument_bytes(tmp_path_factory):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path_factory.mktemp("jax_cache")))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _JAX_ARGUMENT_BYTES, *MEM_ARCHS], env=env,
                       check=True, timeout=900, capture_output=True, text=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", MEM_ARCHS)
def test_argument_bytes_equal_the_references_memory_analysis(arch, jax_argument_bytes):
    """Every leaf of the port's state keeps the reference's dtype (the step
    counter and the optimizer's count are 0-d int32 tensors, as JAX's
    ``jnp.int32`` leaves), so the sums agree to the byte."""
    low = D.lower_train(load_config(arch, reduced=True), CELL, make_local_mesh(device="cpu"),
                        unroll=False)
    stats = D._compile_stats(low)
    assert stats["mem"]["argument_bytes"] == jax_argument_bytes[arch]
    leaves = D.argument_bytes(low)
    assert leaves["arg0/step"] == 4 and leaves["arg0/opt/t"] == 4
    assert stats["mem"]["argument_bytes"] == sum(leaves.values())


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_argument_bytes_equal_a_live_state_and_batch(optimizer):
    """Phase 28(a) on the CPU: a state built for real (seeded init, the
    optimizer's moments, the step counter) plus the step's batch holds
    exactly the dry run's argument bytes on a one-device mesh; a dry run
    that leaves out the optimizer moments fails the equality."""
    from repro_torch.data.synthetic import place, synth_batch
    from repro_torch.train.trainer import make_train_step

    cfg = load_config("qwen2-7b", reduced=True)
    pcfg, tcfg = ParallelConfig(grad_accum=2, remat="full"), TrainConfig(optimizer=optimizer)
    arch = registry.bundle_from_cfg(cfg, "cpu")
    init_state, step = make_train_step(arch, pcfg, tcfg)
    state = init_state(0)
    batch = place(synth_batch(arch.input_specs(CELL), cfg, 0, 0), "cpu")
    state, _ = step(state, batch)                  # the state a run holds after a step
    low = D.lower_train(cfg, CELL, make_local_mesh(device="cpu"), unroll=False, pcfg=pcfg,
                        tcfg=tcfg)
    predicted = D._compile_stats(low)["mem"]["argument_bytes"]
    live = D.leaf_bytes((state, batch))
    assert D.argument_bytes(low) == live and predicted == sum(live.values())
    state_abs, batch_abs = low.args
    no_moments = dataclasses.replace(
        low, args=(state_abs._replace(opt={"t": state_abs.opt["t"]}), batch_abs),
        specs=(low.specs[0]._replace(opt={"t": None}), low.specs[1]))
    assert sum(D.argument_bytes(no_moments).values()) != sum(live.values())


def test_argument_bytes_divide_by_the_spec_axes():
    """On the production mesh each leaf's bytes divide by the sizes of the
    axes its spec names: the embedding (vocab on model, d on data) by 256,
    a replicated norm scale and the step counter not at all."""
    cfg = load_config("qwen2-7b")
    mesh = make_production_mesh(device="cpu")
    cell = ShapeConfig("t", 64, 32, "train")
    low = D.lower_train(cfg, cell, mesh, unroll=True)
    leaves = D.argument_bytes(low)
    embed = cfg.vocab * cfg.d_model * 2
    assert leaves["arg0/params/embed"] == embed // 256
    assert leaves["arg0/opt/m/embed"] == embed * 2 // 256         # fp32 moment
    assert leaves["arg0/params/final_norm/scale"] == cfg.d_model * 2
    assert leaves["arg0/step"] == 4
    assert leaves["arg1/tokens"] == 32 * 64 * 4 // 16            # rows over data 16
    low4 = D.lower_train(cfg, CELL, mesh, unroll=True)         # 4 rows do not divide: whole
    assert D.argument_bytes(low4)["arg1/tokens"] == 4 * 64 * 4


REFERENCE_KEYS = [
    "arch", "shape", "mesh", "kind", "devices", "layout", "params_total", "params_active",
    "full", "rates", "hbm_ok", "flops_per_device", "bytes_per_device", "coll_ring_per_device",
    "coll_naive_per_device", "compute_s", "memory_s", "collective_s", "dominant", "bound_s",
    "model_flops_global", "model_flops_per_device", "useful_ratio", "roofline_fraction",
]


def test_run_cell_has_the_references_keys_and_counts_per_device():
    res = D.run_cell("qwen2-7b", "train_4k", "single", device="cpu",
                     cfg_transform=lambda c: dataclasses.replace(c, n_layers=2))
    assert list(res) == REFERENCE_KEYS
    assert sorted(res["full"]) == ["bytes", "coll_count", "coll_naive", "coll_ring",
                                   "compile_s", "flops", "mem"]
    assert sorted(res["full"]["mem"]) == ["alias_bytes", "argument_bytes", "output_bytes",
                                          "temp_bytes", "total_bytes"]
    assert res["full"]["coll_ring"] is None and res["full"]["mem"]["temp_bytes"] is None
    assert res["devices"] == 256 and res["collective_s"] == 0.0
    r = res["rates"]
    assert r["method"] == "direct+flash-analytic" and r["periods"] == 2
    assert r["scaled_flops"] == res["full"]["flops"]
    assert res["flops_per_device"] == res["full"]["flops"] + r["flash_flops_global"] / 256
    assert math.isclose(res["roofline_fraction"],
                        res["model_flops_per_device"] / 989e12 / res["bound_s"])
    assert "collective=n/a" in D.summarize(res)


def _main(*argv) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = D.main(list(argv))
    return rc, buf.getvalue()


def test_cli_decode_cell_skip_and_list(tmp_path):
    rc, out = _main("--arch", "stablelm-1.6b", "--shape", "decode_32k", "--device", "cpu",
                    "--outdir", str(tmp_path))
    assert rc == 0 and "[stablelm-1.6b x decode_32k @ single]" in out
    res = json.loads((tmp_path / "stablelm-1.6b__decode_32k__single.json").read_text())
    assert list(res) == REFERENCE_KEYS and res["rates"] == {"method": "direct"}
    assert res["dominant"] == "memory" and res["hbm_ok"] is True
    rc, out = _main("--arch", "qwen2-7b", "--shape", "long_500k", "--device", "cpu",
                    "--outdir", str(tmp_path), "--suffix", "_x")
    assert rc == 0 and "SKIP" in out
    assert "skipped" in json.loads((tmp_path / "qwen2-7b__long_500k__single_x.json").read_text())
    rc, out = _main("--all", "--mesh", "both", "--list")
    assert rc == 0 and len(out.splitlines()) == 80


def test_cli_records_a_failing_cell(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("data-dependent")

    monkeypatch.setattr(D, "run_cell", boom)
    rc, out = _main("--arch", "qwen2-7b", "--shape", "train_4k", "--device", "cpu",
                    "--outdir", str(tmp_path))
    assert rc == 1 and "FAIL: RuntimeError: data-dependent" in out
    res = json.loads((tmp_path / "qwen2-7b__train_4k__single.json").read_text())
    assert res["error"] == "RuntimeError: data-dependent" and "traceback" in res


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        D.run_cell("stablelm-1.6b", "decode_32k", "single")


# ---------------------------------------------------------------------------
# the train launcher's --mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,groups", [("local", 1), ("single", 4), ("multi", 4)])
def test_train_launcher_runs_the_lm_step_under_the_mesh(monkeypatch, mesh, groups):
    """One reduced Mixtral step: the MoE dispatch reads the mesh's data
    axes (gcd(16 or 32, 4 rows) groups), as the reference's under
    ``sharding_ctx(mesh)``."""
    from repro_torch.launch import train
    from repro_torch.models import mlp

    seen = []
    real = mlp._dispatch_groups
    monkeypatch.setattr(mlp, "_dispatch_groups", lambda b: seen.append(real(b)) or seen[-1])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["--arch", "mixtral-8x22b", "--device", "cpu", "--steps", "1",
                         "--batch", "4", "--seq", "16", "--mesh", mesh])
    out = buf.getvalue()
    assert rc == 0 and "done: steps=1" in out
    want = {"local": {"data": 1, "model": 1}, "single": {"data": 16, "model": 16},
            "multi": {"pod": 2, "data": 16, "model": 16}}[mesh]
    assert f"mesh={want}" in out
    assert seen and set(seen) == {groups}
