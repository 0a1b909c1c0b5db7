"""Architecture and run configuration: ``repro/configs/base.py``.

One ``ModelConfig`` describes any of the reference's architectures, with the
same fields and defaults; ``act_dtype`` and ``p_dtype`` are torch dtypes.
Every config of the reference resolves in ``models.registry``, and every
field is here so a config file reads the same.  ``ParallelConfig`` keeps
the fields the port reads, with the reference's defaults: ``grad_accum``
(both paths) and the LM step's ``remat``, ``ce_chunk`` and ``unroll``.
``TrainConfig`` has all of the reference's fields; the launchers take the
checkpoint cadence from ``--ckpt-every`` and the logging cadence from
``--log-every``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""

    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD."""

    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 1e6
    rope_pct: float = 1.0           # partial rotary (stablelm: 0.25)
    use_rope: bool = True           # jamba: no positional encoding
    max_pos: int = 32_768           # learned-position table size (whisper dec)
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rmsnorm"
    parallel_block: bool = False    # command-r style attn || mlp
    act: str = "silu"
    logit_softcap: Optional[float] = None
    # family extensions
    moe: Optional[MoEConfig] = None
    moe_layer_stride: int = 1       # apply MoE every k-th layer (jamba: 2)
    moe_first_dense: int = 0        # leading dense layers (deepseek: 3)
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_layer_period: int = 0      # hybrid: 1 attn per period (jamba: 8)
    attn_layer_offset: int = 3      # position of attn layer inside period
    swa_window: Optional[int] = None
    mrope_sections: Optional[tuple[int, ...]] = None
    encoder_decoder: bool = False
    n_encoder_layers: int = 0
    frontend: Optional[str] = None  # "audio" | "vision" stubs
    mtp_depth: int = 0              # deepseek multi-token prediction heads
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid (jamba) layouts: one attention layer per period; pure SSM
        families have none; everything else is all-attention."""
        if self.family == "ssm":
            return False
        if self.attn_layer_period:
            return i % self.attn_layer_period == self.attn_layer_offset
        return True

    def sub_quadratic(self) -> bool:
        """True if serve-time cost per token is o(seq): SSM/hybrid state or
        bounded attention windows on every attention layer (the reference's;
        ``models.registry.cell_supported`` reads it)."""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True  # attn layers still full; cache sharded over seq
        return self.swa_window is not None

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe_first_dense:
            return False
        return (i - self.moe_first_dense) % self.moe_layer_stride == 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How a model maps onto the device: microbatches, and the LM step's
    rematerialisation, cross-entropy chunk and (analysis) unrolling.  The
    port holds only the fields it reads: the reference's mesh axes,
    ``seq_shard_cache``, ``shard_moe_tokens`` and ``layout`` have no reader
    here (a sequence-sharded decode is ``decode_step``'s
    ``seq_sharded_cache``; a layout's rules are ``parallel.api.layout_rules``,
    given to ``sharding_ctx``)."""

    remat: str = "full"              # none | full | dots
    grad_accum: int = 1
    unroll: bool = False
    ce_chunk: int = 512              # cross-entropy streaming chunk


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup: int = 100
    optimizer: str = "adamw"         # adamw | adafactor | sgd
    grad_clip: float = 1.0
    grad_compression: Optional[str] = None   # None | "int8"
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    seed: int = 0
