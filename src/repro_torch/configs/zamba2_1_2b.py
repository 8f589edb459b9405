"""Zamba2-1.2B: 38 Mamba2 layers d_model=2048, shared attention block
(32H MHA, d_ff=8192) applied every 6 SSM layers, vocab=32000,
ssm_state=64.  [arXiv:2411.15242]

Its recurrent state (SSM and conv windows) has no row per token, so it
pads prompts on the left and takes the dense slot layout only."""
from repro_torch.configs.base import AttnConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000, head_dim=64,
    attn=AttnConfig(rope_theta=10_000.0),
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256, ngroups=1),
    attn_every=6, mlp_act="silu", gated_mlp=True,
    supports_long_decode=True,
    source="arXiv:2411.15242",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=503, attn_every=2,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4,
                      chunk_size=16, ngroups=1))
