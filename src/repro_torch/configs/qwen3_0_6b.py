"""Qwen3-0.6B: 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936,
qk-norm, tied embeddings.  [hf:Qwen/Qwen3-8B family, 0.6B spec]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=3072, vocab_size=151936, head_dim=128,
    attn=AttnConfig(qk_norm=True, rope_theta=1_000_000.0),
    mlp_act="silu", gated_mlp=True, tie_embeddings=True,
    source="hf:Qwen/Qwen3-8B (family card; 0.6B spec per assignment)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=128, num_heads=4,
                          num_kv_heads=2, head_dim=32, d_ff=256,
                          vocab_size=503)
