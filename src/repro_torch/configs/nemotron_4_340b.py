"""Nemotron-4-340B: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000, squared-ReLU (non-gated) MLP.  [arXiv:2402.16819]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, head_dim=192,
    attn=AttnConfig(rope_theta=10_000.0),
    mlp_act="relu2", gated_mlp=False,
    source="arXiv:2402.16819",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=192, num_heads=6,
                          num_kv_heads=2, head_dim=32, d_ff=512,
                          vocab_size=503)
