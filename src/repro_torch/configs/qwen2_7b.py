"""Qwen2-7B [arXiv:2407.10671] - dense, GQA kv=4, QKV bias."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab=152064,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    source="arXiv:2407.10671",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        dtype="float32", param_dtype="float32",
    )
