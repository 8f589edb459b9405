"""Whisper-small: enc-dec, 12+12L d_model=768 12H (MHA) d_ff=3072
vocab=51865; conv/mel frontend STUB (precomputed frame embeddings,
1500 encoder positions); learned decoder positions, LayerNorm, GELU.
[arXiv:2212.04356]

Its cache has four keys (the decoder's own K/V and the cross K/V of the
encoder's 1500 rows), so it takes the dense slot layout only."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    attn=AttnConfig(),
    mlp_act="gelu", gated_mlp=False, norm_type="layernorm",
    pos_embedding="learned", max_position=33_024,
    encoder_layers=12, encoder_positions=1500,
    num_stub_positions=1500, stub_kind="audio_frames",
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, encoder_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=4, head_dim=32, d_ff=256,
                          vocab_size=503, max_position=256,
                          encoder_positions=32, num_stub_positions=32)
