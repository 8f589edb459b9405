"""Model configs with torch dtypes (counterpart of ``repro/configs/base.py``).

Field names, defaults and meanings are the reference's; only
``param_dtype``/``compute_dtype`` hold ``torch.dtype`` values.  The
registry holds every architecture of the reference's: dense, MoE,
hybrid (Mamba2 with a shared attention block), ssm (xLSTM),
vision-language and audio.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    experts_per_token: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    router_z_weight: float = 1e-3
    d_ff_shared: int = 0


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    head_dim: int = 64
    num_heads: int = 0
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256
    ngroups: int = 1


@dataclass(frozen=True)
class AttnConfig:
    qk_norm: bool = False        # qwen3: RMSNorm on per-head q/k
    qkv_bias: bool = False
    attn_softcap: float = 0.0
    sliding_window: int = 0
    layer_pattern: str = "global"
    rope_theta: float = 10_000.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    attn: AttnConfig = field(default_factory=AttnConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mlp_act: str = "silu"        # silu | relu2 | gelu
    gated_mlp: bool = True
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    norm_eps: float = 1e-6
    pos_embedding: str = "rope"  # rope | learned | sinusoidal | none
    tie_embeddings: bool = False
    scale_embeddings: bool = False
    logit_softcap: float = 0.0
    max_position: int = 1 << 20
    attn_every: int = 0
    num_stub_positions: int = 0
    stub_kind: str = "none"
    encoder_layers: int = 0
    encoder_positions: int = 0
    remat: bool = False
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    supports_long_decode: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


ARCH_IDS = ("qwen3_moe_235b_a22b", "qwen3_0_6b", "nemotron_4_340b",
            "qwen1_5_110b", "zamba2_1_2b", "xlstm_125m", "gemma2_2b",
            "granite_moe_3b_a800m", "phi_3_vision_4_2b", "whisper_small")
ARCH_ALIASES = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "qwen3-0.6b": "qwen3_0_6b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen1.5-110b": "qwen1_5_110b",
    "zamba2-1.2b": "zamba2_1_2b",
    "xlstm-125m": "xlstm_125m",
    "gemma2-2b": "gemma2_2b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "phi-3-vision-4.2b": "phi_3_vision_4_2b",
    "whisper-small": "whisper_small",
}


def _module(arch: str):
    mod_name = ARCH_ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"arch {arch!r} not ported; ported: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced variant of the same family (the reference's smoke config:
    2 layers, narrow widths, 503 ids)."""
    return _module(arch).smoke_config()


def tiny_lm_config(vocab_size: int, d_model: int = 128, layers: int = 4,
                   heads: int = 4) -> ModelConfig:
    """The RL session's tiny dense LM (``repro/rl/session.py``)."""
    return ModelConfig(
        name="tiny-lm", family="dense", num_layers=layers, d_model=d_model,
        num_heads=heads, num_kv_heads=heads, d_ff=4 * d_model,
        vocab_size=vocab_size, attn=AttnConfig(rope_theta=10_000.0),
        tie_embeddings=True, param_dtype=torch.float32,
        compute_dtype=torch.float32)
