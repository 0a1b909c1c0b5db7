"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01] - dense, GQA kv=8,
no biases, parallel attn||mlp blocks, LayerNorm, tied embeddings."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    rope_theta=8_000_000.0,
    qkv_bias=False,
    norm="layernorm",
    parallel_block=True,
    tie_embeddings=True,
    act="silu",
    source="hf:CohereForAI/c4ai-command-r-v01",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
        dtype="float32", param_dtype="float32",
    )
