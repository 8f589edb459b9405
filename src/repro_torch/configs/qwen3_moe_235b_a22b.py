"""Qwen3-MoE-235B-A22B: 94L d_model=4096 64H (GQA kv=4) d_ff_expert=1536,
vocab=151936, MoE 128 experts top-8, qk-norm.  [hf:Qwen/Qwen3-30B-A3B
scaled per assignment spec]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4,
    d_ff=0, vocab_size=151936, head_dim=128,
    attn=AttnConfig(qk_norm=True, rope_theta=1_000_000.0),
    moe=MoEConfig(num_experts=128, experts_per_token=8, d_ff_expert=1536),
    mlp_act="silu", gated_mlp=True,
    source="hf:Qwen/Qwen3-30B-A3B (assignment spec)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
        vocab_size=503,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=64,
                      capacity_factor=2.0))
