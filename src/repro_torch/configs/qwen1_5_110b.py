"""Qwen1.5-110B: 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064,
QKV bias.  [hf:Qwen/Qwen1.5-0.5B family card; 110B spec per assignment]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152064, head_dim=128,
    attn=AttnConfig(qkv_bias=True, rope_theta=1_000_000.0),
    mlp_act="silu", gated_mlp=True,
    source="hf:Qwen/Qwen1.5-0.5B (family card)",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=128, num_heads=4,
                          num_kv_heads=2, head_dim=32, d_ff=256,
                          vocab_size=503)
