"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b] - dense, LayerNorm,
partial rotary (25%)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    rope_theta=10_000.0,
    rope_pct=0.25,
    qkv_bias=False,
    norm="layernorm",
    act="silu",
    source="hf:stabilityai/stablelm-2-1_6b",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        dtype="float32", param_dtype="float32",
    )
