"""Jamba-v0.1 52B [arXiv:2403.19887] - hybrid Mamba+attention 1:7
interleave, MoE 16 experts top-2 on alternate layers, no positional
encoding on the attention layers.

Layout per 8-layer period: attention at offset 4 (0-indexed), Mamba
elsewhere; MoE replaces the MLP on odd layers (offset 1, stride 2).
The Mamba mixer is implemented in the SSD (Mamba2) formulation - the
chunked-matmul form of the reference (its DESIGN.md §2); d_state 16 as
published.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    use_rope=False,
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
    moe_first_dense=1,        # + stride 2 => MoE on odd layers (offset 1)
    moe_layer_stride=2,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    attn_layer_period=8,
    attn_layer_offset=4,
    source="arXiv:2403.19887",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=16),
        attn_layer_period=8, attn_layer_offset=4,
        dtype="float32", param_dtype="float32",
    )
