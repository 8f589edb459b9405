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
from typing import Any, Optional, Tuple

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

    def param_count(self) -> int:
        """Analytic total parameter count (for 6ND roofline terms)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        return _param_count(self, active_only=True)


def _dense_block_params(cfg: ModelConfig, d_ff: int) -> int:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = d * hd * (cfg.num_heads + 2 * cfg.num_kv_heads)  # qkv
    attn += cfg.num_heads * hd * d                          # out proj
    if cfg.attn.qkv_bias:
        attn += hd * (cfg.num_heads + 2 * cfg.num_kv_heads)
    mlp = d * d_ff * (3 if cfg.gated_mlp else 2)
    norms = 2 * d
    return attn + mlp + norms


def _ssm_block_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    nheads = s.num_heads or d_inner // s.head_dim
    in_proj = d * (2 * d_inner + 2 * s.ngroups * s.state_dim + nheads)
    conv = (d_inner + 2 * s.ngroups * s.state_dim) * s.conv_width
    out = d_inner * d
    extras = 2 * nheads + d_inner + d  # A_log, dt_bias, norm, layer norm
    return in_proj + conv + out + extras


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """The reference's analytic count, term for term (its ssm count is
    rough, and so is this one: the launch path reads the exact count from
    the parameter tree)."""
    n = cfg.vocab_size * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        n += cfg.vocab_size * cfg.d_model
    n += cfg.d_model  # final norm
    if cfg.family in ("dense", "vlm"):
        n += cfg.num_layers * _dense_block_params(cfg, cfg.d_ff)
    elif cfg.family == "moe":
        m = cfg.moe
        per = _dense_block_params(cfg, 0)  # attn + norms only
        router = cfg.d_model * m.num_experts
        e = m.experts_per_token if active_only else m.num_experts
        expert = e * cfg.d_model * m.d_ff_expert * 3
        shared = cfg.d_model * m.d_ff_shared * 3 if m.d_ff_shared else 0
        n += cfg.num_layers * (per + router + expert + shared)
    elif cfg.family == "hybrid":
        n += cfg.num_layers * _ssm_block_params(cfg)
        n_attn = max(1, cfg.num_layers // max(cfg.attn_every, 1))
        n += n_attn and _dense_block_params(cfg, cfg.d_ff)  # shared block
    elif cfg.family == "ssm":
        # xlstm: alternating sLSTM / mLSTM; rough analytic count
        d = cfg.d_model
        n += cfg.num_layers * (8 * d * d)
    elif cfg.family == "audio":
        n += cfg.num_layers * (_dense_block_params(cfg, cfg.d_ff)
                               + cfg.d_model * cfg.resolved_head_dim
                               * (cfg.num_heads + 2 * cfg.num_kv_heads)
                               + cfg.num_heads * cfg.resolved_head_dim
                               * cfg.d_model
                               + cfg.d_model)  # + cross-attn
        n += cfg.encoder_layers * _dense_block_params(cfg, cfg.d_ff)
    return int(n)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


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
    mod_name = arch_key(arch)
    if mod_name not in ARCH_IDS:
        raise KeyError(f"arch {arch!r} not ported; ported: {list(ARCH_IDS)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def arch_key(arch: str) -> str:
    """Module name of a public ``--arch`` id (the plans' key)."""
    return ARCH_ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}


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
