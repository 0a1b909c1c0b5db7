"""The reference dry run's depth scaling against the port's direct count
(``launch/dryrun.py``): the counts at depths d1 and d2, scaled by the
reference's ``s1 + (R - 1)(s2 - s1)``, equal the direct full-depth count
for every architecture's reduced config, with remat "none" and "full" -
but where a shallow config's segment plan has other block boundaries than
the full one (DeepSeek-V3).  Whole file ~45 s on one worker."""
import functools

import pytest

from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import registry
from repro_torch.models.attention import attention_impl
from repro_torch.models.registry import load_config, period_counts, with_depth

SHORT = ShapeConfig("t", 32, 2, "train")      # few SSD chunks to trace


def _blocks(cfg) -> list:
    """The block boundaries of a config's segment plan: (start, block length)."""
    from repro_torch.models.lm import plan_segments

    return [(s.start + r * len(s.block), len(s.block)) for s in plan_segments(cfg)
            for r in range(s.repeats)]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_depth_scaled_counts_equal_the_direct_count(arch, remat):
    """The reference's method (two shallow depths, scaled) reproduces the
    port's direct full-depth count, every layer of a period costing the
    same, where the shallow configs keep the full plan's block boundaries.
    DeepSeek-V3's 1-period config (its dense prefix and one MoE layer) plans
    one block of both: under remat "full" torch's checkpoint stops each
    block's recomputation after the last tensor the backward reads, so that
    block recomputes the dense layer's trailing matmuls the full plan's
    blocks do not, and the scaled count is off by them - why the dry run
    counts directly.  Train under the stub, as the dry run counts it."""
    cfg = load_config(arch, reduced=True)
    mesh = make_local_mesh(device="cpu")
    prefix, reps = period_counts(cfg)
    pcfg = ParallelConfig(remat=remat)

    @functools.lru_cache(maxsize=None)       # a 1-period config may be the config itself
    def count(c):
        with attention_impl("stub"):
            return D._compile_stats(D.lower_train(c, SHORT, mesh, unroll=True, pcfg=pcfg))["flops"]

    d1, d2 = with_depth(cfg, 1), with_depth(cfg, 2)
    s1, s2, full = count(d1), count(d2), count(cfg)
    assert s2 > s1 > 0
    scaled = s1 + (reps - 1) * (s2 - s1)
    same_blocks = _blocks(d1) == _blocks(cfg)[:len(_blocks(d1))]
    if remat == "none" or same_blocks:
        assert scaled == full
    else:
        assert arch == "deepseek-v3-671b" and prefix and _blocks(d1) == [(0, prefix + 1)]
        mlp_down = 2 * SHORT.global_batch * SHORT.seq_len * cfg.d_ff * cfg.d_model
        # s1 holds one more recomputed w_down forward than a full-plan block
        # recomputes, and s1 + (R - 1)(s2 - s1) = 2 s2 - s1 for R = 3
        assert reps == 3 and full - scaled == mlp_down
