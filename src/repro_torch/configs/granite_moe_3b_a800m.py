"""Granite-MoE-3B-A800M: 32L d_model=1536 24H (GQA kv=8) d_ff_expert=512
vocab=49155, MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]

As in the reference: the assignment's structured spec field says "MoE 40e
top-8" while its free text says "32 experts top-8"; the structured field
(40) is followed."""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=0, vocab_size=49155, head_dim=64,
    attn=AttnConfig(rope_theta=10_000.0),
    moe=MoEConfig(num_experts=40, experts_per_token=8, d_ff_expert=512),
    mlp_act="silu", gated_mlp=True, tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=8, num_kv_heads=2, head_dim=16,
        vocab_size=503,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff_expert=64,
                      capacity_factor=2.0))
