"""Roofline analysis over the dry run's counts (``repro/analysis``).

The collective half of the reference's ``analysis/hlo.py`` is
``collectives.py``: ``CollectiveStats`` and the ring model, filled from the
collectives a rank records (``parallel/dist.py``) instead of HLO text, and
``plan_collectives``, what a plan's ranks must record.  The
rest (HLO parsing, scan trip counts, Pallas grids) has no counterpart: the
port emits no HLO, and a kernel's launches by instance are counted by its
wrapper (``chip_smoke.py``'s ``{"kernels": ...}`` line).
"""
from repro_torch.analysis.collectives import (
    CollectiveStats,
    collective_stats,
    leaf_bytes,
    plan_collectives,
)
from repro_torch.analysis.roofline import (
    H100,
    H100_FP32_PEAK_FLOPS,
    V5E,
    HardwareTarget,
    RooflineTerms,
    count_params_cfg,
    embed_param_count,
    flash_attention_terms,
    fmt_bytes,
    fmt_flops,
    fmt_seconds,
    model_flops,
    terms_from_counts,
)
