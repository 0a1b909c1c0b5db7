"""Roofline analysis over the dry run's counts (``repro/analysis``).

The reference's ``analysis/hlo.py`` (collective traffic parsed from
compiled HLO text, scan trip counts, Pallas grids) has no counterpart: the
port emits no HLO and runs no collective on one card, and a kernel's
launches by instance are counted by its wrapper (``chip_smoke.py``'s
``{"kernels": ...}`` line).
"""
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
