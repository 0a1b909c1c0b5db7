"""Mixtral-8x22B [arXiv:2401.04088] - MoE 8 experts top-2, GQA kv=8,
sliding-window attention (the paper-technique 1-D halo operator)."""
import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=32768,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
    swa_window=4096,
    source="arXiv:2401.04088",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128), swa_window=16,
        dtype="float32", param_dtype="float32",
    )
