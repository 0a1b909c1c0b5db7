"""Qwen2-VL-2B [arXiv:2409.12191] - VLM: decoder LM with M-RoPE; the vision
frontend is a stub (the input specs supply precomputed patch embeddings).

head_dim = 1536/12 = 128; M-RoPE sections (temporal, h, w) = (16, 24, 24)
over the 64 frequency slots.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
    norm="rmsnorm",
    act="silu",
    mrope_sections=(16, 24, 24),
    frontend="vision",
    source="arXiv:2409.12191",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        mrope_sections=(4, 2, 2),
        dtype="float32", param_dtype="float32",
    )
