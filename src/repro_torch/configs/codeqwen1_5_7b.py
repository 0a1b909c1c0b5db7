"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] - dense, qwen1.5 arch (QKV bias)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab=92416,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    source="hf:Qwen/CodeQwen1.5-7B",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        dtype="float32", param_dtype="float32",
    )
