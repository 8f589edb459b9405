"""xLSTM-125M: 12 blocks (alternating mLSTM / sLSTM) d_model=768 4H,
vocab=50304, no positional embedding (recurrence encodes order).
[arXiv:2405.04517]

A recurrent state only (no KV cache): it pads prompts on the left and
takes the dense slot layout."""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    num_layers=12, d_model=768, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=192,
    attn=AttnConfig(),
    norm_type="layernorm", pos_embedding="none",
    supports_long_decode=True,
    source="arXiv:2405.04517",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(num_layers=2, d_model=128, num_heads=4,
                          head_dim=32, vocab_size=503)
