"""Phi-3-Vision-4.2B: phi3-mini backbone 32L d_model=3072 32H (MHA kv=32)
d_ff=8192 vocab=32064 + CLIP vision frontend (STUB per the carve-out:
``input_specs`` feeds 576 precomputed patch embeddings).
[hf:microsoft/Phi-3-vision-128k-instruct]

The 576 patch rows go before the prompt's tokens in every prefill
(``Model.prefill_extra``), so a slot's cache holds 576 rows more than
its tokens; the segment-packed prefill does not take them."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    attn=AttnConfig(rope_theta=10_000.0),
    mlp_act="silu", gated_mlp=True,
    num_stub_positions=576, stub_kind="vision_patches",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=128, num_heads=4,
                          num_kv_heads=4, head_dim=32, d_ff=256,
                          vocab_size=503, num_stub_positions=16)
