"""Three-term roofline model over the dry run's counts:
``repro/analysis/roofline.py``, with the same arithmetic.

    compute    = FLOPs_per_device / peak_FLOPs
    memory     = bytes_per_device / HBM_bw
    collective = ring_collective_bytes_per_device / (link_bw * links)

The counts come from ``launch/dryrun.py``: ``FlopCounterMode`` and a
dispatch-level byte count over the step traced on fake tensors, at full
depth (torch has no scan body counted once, so no depth scaling is needed).
The dominant term approximates step time on hardware that overlaps the
other two; ``model_flops`` gives the useful-work numerator of the roofline
fraction MODEL_FLOPS / (chips * peak * dominant_term).

Targets: ``H100``, the card the port runs on (its dense bf16 tensor-core
peak, HBM3 rate and size; ``H100_FP32_PEAK_FLOPS`` beside it is the fp32
CUDA-core peak the fp32 kernels' bounds use), and the reference's ``V5E``,
kept so that the dry run's numbers can be held against the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class HardwareTarget:
    name: str = "tpu-v5e"
    peak_flops: float = 197e12        # bf16 FLOP/s per chip
    hbm_bw: float = 819e9             # bytes/s per chip
    ici_bw: float = 50e9              # bytes/s per ICI link
    ici_links: int = 1                # conservative: count one link
    dcn_bw: float = 6.25e9            # bytes/s per host cross-pod (50 Gbps)
    hbm_bytes: float = 16e9           # v5e HBM capacity


V5E = HardwareTarget()

#: One H100 SXM 80GB at 700 W (NVIDIA's data sheet): the dense bf16
#: tensor-core peak, the HBM3 rate and size.  Its interconnect fields take
#: the published NVLink 4 rate of one H100 SXM (900 GB/s); a one-card run
#: runs no collective and never reads them.
H100 = HardwareTarget(
    name="h100-sxm-80gb",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=900e9,
    ici_links=1,
    dcn_bw=900e9,
    hbm_bytes=80e9,
)
#: The fp32 peak of the same card on its CUDA cores (no tensor cores): the
#: bound of the fp32 kernels (B1-B3, B4's and B5's SIMT instances).
H100_FP32_PEAK_FLOPS = 67e12


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float                      # per device
    bytes_hbm: float                  # per device
    bytes_coll: float                 # per device (ring model)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def terms_from_counts(
    flops: float,
    bytes_hbm: float,
    bytes_coll: float,
    hw: HardwareTarget = V5E,
) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops / hw.peak_flops,
        memory_s=bytes_hbm / hw.hbm_bw,
        collective_s=bytes_coll / (hw.ici_bw * hw.ici_links),
        flops=flops,
        bytes_hbm=bytes_hbm,
        bytes_coll=bytes_coll,
    )


# ---------------------------------------------------------------------------
# Useful-work model FLOPs (6ND and friends)
# ---------------------------------------------------------------------------


def count_params_cfg(abstract_params: Any, cfg: ModelConfig) -> tuple[int, int]:
    """(total, active) parameter counts from the abstract param tree (any
    tree of tensors, ``meta`` or not, whose leaves have ``shape``).

    Active discounts routed-expert weights by top_k/n_experts (a token's
    forward touches only the selected experts); everything else is active.
    Paths are ``ckpt/manager.py:map_with_path``'s, spelled as the
    reference's ``keystr_slash``.
    """
    from repro_torch.ckpt.manager import map_with_path

    counts = [0, 0]
    ratio = cfg.moe.top_k / cfg.moe.n_experts if cfg.moe is not None else 1.0

    def leaf(key: str, x) -> None:
        n = 1
        for s in x.shape:
            n *= s
        counts[0] += n
        # stacked routed experts sit at ...["moe"]["w_gate"|"w_up"|"w_down"]
        if cfg.moe is not None and "moe" in key and (
            "w_gate" in key or "w_up" in key or "w_down" in key
        ):
            counts[1] += int(n * ratio)
        else:
            counts[1] += n

    map_with_path(leaf, abstract_params)
    return counts[0], counts[1]


def embed_param_count(cfg: ModelConfig) -> int:
    """Params that do no matmul work: the lookup-only input embedding.
    (Tied embeddings serve as the LM head, whose matmul DOES count.)"""
    return 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model


def model_flops(
    cfg: ModelConfig,
    shape: ShapeConfig,
    n_active_params: int,
    *,
    embed_params: int = 0,
) -> float:
    """Useful training/serving FLOPs per global step.

    train:   6 * N_active * tokens  + attention quadratic term
    prefill: 2 * N_active * tokens  + attention quadratic term (fwd only)
    decode:  2 * N_active * batch   + KV-cache attention reads (fwd, 1 token)

    The quadratic attention term per layer: 12*B*T^2*d_qk (train, causal/2)
    or 4*B*T^2*d (fwd) with window clamping for SWA; SSM layers contribute
    their chunked-scan term instead (folded into 6ND via state dims, small).
    """
    b, t = shape.global_batch, shape.seq_len
    tokens = b * t
    n_mat = max(n_active_params - embed_params, 1)
    dh = cfg.resolved_head_dim
    d_attn = cfg.n_heads * dh

    # attention-layer census
    attn_layers = sum(1 for i in range(cfg.n_layers) if cfg.is_attn_layer(i))

    if shape.kind == "decode":
        # one token, full-cache attention read: 2 matmul * cache_len * d_attn
        flops = 2.0 * n_mat * b
        cache = min(t, cfg.swa_window) if cfg.swa_window else t
        if cfg.family in ("ssm",):
            attn_flops = 0.0
        else:
            attn_flops = attn_layers * 4.0 * b * cache * d_attn
        return flops + attn_flops

    fwd_bwd = 6.0 if shape.kind == "train" else 2.0
    flops = fwd_bwd * n_mat * tokens
    # causal attention: ~T^2/2 effective pairs; SWA clamps to T*W
    pairs = t * min(t, cfg.swa_window) if cfg.swa_window else t * t / 2
    attn_mult = 2.0 * fwd_bwd                      # QK^T and AV, fwd(+bwd)
    attn_flops = attn_layers * attn_mult * b * pairs * d_attn
    return flops + attn_flops


def flash_attention_terms(
    cfg: ModelConfig,
    shape: ShapeConfig,
    *,
    q_block: int = 1024,
    remat: bool = True,
) -> tuple[float, float]:
    """Analytic (FLOPs, HBM bytes) of ALL attention layers per global step,
    modelling a flash kernel (streaming KV, no T^2 HBM traffic).

    The dry run's counting trace replaces attention with a zero-FLOP stub
    (``models.attention._sdpa_stub``, which also stands in for B4) and adds
    these terms back, so the roofline reflects a flash kernel rather than a
    materialisation the deployed system never runs.

    FLOPs per layer (fwd) = 2*B*pairs*H*d_qk (QK^T) + 2*B*pairs*H*d_v (PV),
    pairs = attended (q,k) pairs: causal T^2/2 (the kernel skips fully-masked
    blocks), window T*W, bidirectional T^2.  Train multiplier: fwd + bwd(2x)
    + remat recompute.

    HBM bytes per layer (fwd): Q+O streamed once; K/V streamed once per
    query block (n_q passes; causal halves the average).  bwd ~ 2.5x fwd.
    """
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return 0.0, 0.0                       # decode is measured directly

    if cfg.mla is not None:
        d_qk = cfg.n_heads * (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim)
        d_v = cfg.n_heads * cfg.mla.v_head_dim
        d_kv_store = d_qk + d_v               # materialised K/V per token
    else:
        d_qk = d_v = cfg.n_heads * cfg.resolved_head_dim
        d_kv_store = (cfg.n_kv_heads * cfg.resolved_head_dim) * 2

    train = shape.kind == "train"
    fl_mult = (4.0 if remat else 3.0) if train else 1.0
    by_mult = (4.5 if remat else 3.5) if train else 1.0   # fwd + 2.5 bwd (+1 remat)

    def layer_terms(tq, tk, pairs):
        fl = 2.0 * b * pairs * d_qk + 2.0 * b * pairs * d_v
        n_q = max(1, -(-tq // q_block))
        kv_passes = (n_q + 1) / 2 if pairs < tq * tk else n_q   # causal/window skip
        by = 2.0 * b * (tq * (d_qk + d_v) + kv_passes * tk * d_kv_store)
        return fl, by

    flops = bytes_ = 0.0
    if cfg.encoder_decoder:
        n_enc = cfg.n_encoder_layers or cfg.n_layers
        t_dec = max(8, t // 4)                # registry._whisper_input_specs
        f, y = layer_terms(t, t, t * t)       # encoder self (bidirectional)
        flops += n_enc * f
        bytes_ += n_enc * y
        f, y = layer_terms(t_dec, t_dec, t_dec * t_dec / 2)   # decoder self
        flops += cfg.n_layers * f
        bytes_ += cfg.n_layers * y
        f, y = layer_terms(t_dec, t, t_dec * t)               # cross
        flops += cfg.n_layers * f
        bytes_ += cfg.n_layers * y
        return flops * fl_mult, bytes_ * by_mult

    for i in range(cfg.n_layers):
        if not cfg.is_attn_layer(i):
            continue
        w = cfg.swa_window
        pairs = t * min(t, w) if w else t * t / 2
        f, y = layer_terms(t, t, pairs)
        flops += f
        bytes_ += y
    return flops * fl_mult, bytes_ * by_mult


def fmt_seconds(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}us"


def fmt_bytes(b: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(b) < 1024 or unit == "TiB":
            return f"{b:.2f}{unit}"
        b /= 1024
    return f"{b:.2f}TiB"


def fmt_flops(f: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P", "E"):
        if abs(f) < 1000 or unit == "E":
            return f"{f:.2f}{unit}FLOP"
        f /= 1000
    return f"{f:.2f}EFLOP"
