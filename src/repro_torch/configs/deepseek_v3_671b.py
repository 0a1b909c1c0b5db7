"""DeepSeek-V3 671B [arXiv:2412.19437] - MLA + MoE 256 routed (top-8) +
1 shared expert + MTP.

Assignment line: 61L d_model=7168 128H d_ff=2048 vocab=129280.  d_ff=2048 is
the per-expert (and shared-expert) intermediate size; the 3 leading dense
layers use the paper's 18432 dense intermediate.  MLA dims from the paper:
q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v 128.
"""
import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,               # dense layers 0-2 (paper §4.2)
    vocab=129280,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        d_ff_shared=2048,
        capacity_factor=1.25,
    ),
    moe_first_dense=3,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    mtp_depth=1,
    source="arXiv:2412.19437",
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1, d_ff_shared=32),
        moe_first_dense=1,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        mtp_depth=1,
        dtype="float32", param_dtype="float32",
    )
