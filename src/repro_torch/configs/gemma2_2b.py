"""Gemma2-2B: 26L d_model=2304 8H (GQA kv=4) head_dim=256 d_ff=9216
vocab=256000; alternating local(4096)/global attention, attn+final logit
soft-capping, tied + scaled embeddings.  [arXiv:2408.00118]

Local layers keep a ring cache of the window's width; the port serves it
on the dense slot layout (a four-key cache cannot be paged)."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    num_layers=26, d_model=2304, num_heads=8, num_kv_heads=4,
    d_ff=9216, vocab_size=256000, head_dim=256,
    attn=AttnConfig(attn_softcap=50.0, sliding_window=4096,
                    layer_pattern="local_global", rope_theta=10_000.0),
    mlp_act="gelu", gated_mlp=True, tie_embeddings=True,
    scale_embeddings=True, logit_softcap=30.0,
    supports_long_decode=True,
    source="arXiv:2408.00118",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=503,
        attn=AttnConfig(attn_softcap=50.0, sliding_window=16,
                        layer_pattern="local_global"))
