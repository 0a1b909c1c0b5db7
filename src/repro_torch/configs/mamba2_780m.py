"""Mamba2-780m [arXiv:2405.21060] - attention-free SSD (state-space duality).

48 layers, d_model 1536, expand 2 -> d_inner 3072, head_dim 64 -> 48 SSD
heads, d_state 128, causal conv K=4.  No MLP (d_ff=0), tied embeddings.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50280,
    tie_embeddings=True,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=256),
    source="arXiv:2405.21060",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, vocab=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=32),
        dtype="float32", param_dtype="float32",
    )
