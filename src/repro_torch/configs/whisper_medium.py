"""Whisper-medium [arXiv:2212.04356] - encoder-decoder, 24+24 layers,
d_model 1024, 16 heads, GELU MLP d_ff 4096, LayerNorm.

The conv/mel frontend is a stub: the input specs supply precomputed frame
embeddings (B, T_enc, d_model).  Shape mapping: encoder frames = seq_len,
decoder tokens = seq_len / 4 (mirroring Whisper's ~3.3:1 frame:token
ratio).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,              # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    use_rope=False,
    encoder_decoder=True,
    frontend="audio",
    max_pos=32_768 + 8,
    source="arXiv:2212.04356",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=256, max_pos=128,
        dtype="float32", param_dtype="float32",
    )
