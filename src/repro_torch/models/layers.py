"""Shared model building blocks (counterpart of ``repro/models/layers.py``):
norms, rotary embeddings, plain attention (full and blockwise),
projections, MLP.

Plain functions on tensors and dicts of parameters, in the reference's
layouts: q (B, S, H, D), k/v (B, S, Kh, D), ``wq`` (d, H, hd), ``wo``
(H, hd, d).  Rounding follows the reference: norms and rope in f32,
attention scores and softmax in f32, products of the working dtype
accumulated in f32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale.float()).to(dt)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm(x, p: Params, kind: str, eps: float):
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"], eps)
    return layernorm(x, p["scale"], p["bias"], eps)


# ---------------------------------------------------------------------------
# Rotary embeddings (half-split form, f32 angles)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions.float()[..., None] * freqs        # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (plain versions; the kernels' references)
# ---------------------------------------------------------------------------


# above this many query rows the plain paths attend blockwise (the
# reference's ``transformer.FULL_ATTN_MAX_SEQ``)
FULL_ATTN_MAX_SEQ = 2048


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


def full_attention(q, k, v, *, causal: bool = True, window: int = 0,
                   softcap: float = 0.0, seg_q=None, seg_k=None
                   ) -> torch.Tensor:
    """Attention that materialises (B, Kh, G, Sq, Sk) f32 scores.

    q: (B, Sq, H, D); k/v: (B, Sk, Kh, D) with H = Kh * G (GQA).
    ``seg_q``/``seg_k``: (B, S) segment ids; a query sees a key only in
    its own segment (pad ids -1 match each other like any id).
    """
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qf = q.float().reshape(B, Sq, Kh, G, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(D)
    scores = _softcap(scores, softcap)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    mask_b = mask.expand(B, Sq, Sk)
    if seg_q is not None:
        mask_b = mask_b & (seg_q[:, :, None] == seg_k[:, None, :])
    scores = scores.masked_fill(~mask_b[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)             # fully-masked rows
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_block: int = 512,
                        k_block: int = 1024, seg_q=None, seg_k=None
                        ) -> torch.Tensor:
    """Memory-bounded attention: a loop over ``q_block``-row query blocks,
    each an online softmax over ``k_block``-row key blocks, so no score
    tensor is larger than (B, H, q_block, k_block) f32.  The reference's
    plain long-sequence path, in its order: q is scaled and rounded to
    its dtype, products accumulate in f32, padded keys are masked by
    ``kpos < Sk``, GQA repeats the kv heads.

    Key blocks that the causal mask or the window hide from a whole
    query block are skipped: such a block leaves the running (m, l, acc)
    exactly as they were, so the result is the reference's, which scans
    every block.  Shapes and segment ids as in :func:`full_attention`.
    """
    B, Sq, H, D = q.shape
    Sk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    Sq_orig, Sk_orig = Sq, Sk
    if Sq % q_block:
        q = F.pad(q, (0, 0, 0, 0, 0, q_block - Sq % q_block))
        Sq = q.shape[1]
        if seg_q is not None:
            seg_q = F.pad(seg_q, (0, Sq - Sq_orig), value=-1)
    if Sk % k_block:
        pad = (0, 0, 0, 0, 0, k_block - Sk % k_block)
        k, v = F.pad(k, pad), F.pad(v, pad)
        Sk = k.shape[1]
        if seg_k is not None:
            seg_k = F.pad(seg_k, (0, Sk - Sk_orig), value=-1)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    scale = 1.0 / math.sqrt(D)
    neg_inf = float("-inf")
    outs = []
    for q0 in range(0, Sq, q_block):
        qblk = (q[:, q0:q0 + q_block].float() * scale).to(q.dtype).float()
        qpos = torch.arange(q0, q0 + q_block, device=q.device)
        m = torch.full((B, H, q_block), neg_inf, device=q.device)
        l = torch.zeros((B, H, q_block), device=q.device)
        acc = torch.zeros((B, H, q_block, D), device=q.device)
        for k0 in range(0, Sk, k_block):
            if causal and k0 > q0 + q_block - 1:
                break                       # above the diagonal from here
            if window and q0 - (k0 + k_block - 1) >= window:
                continue                    # wholly outside the window
            kpos = torch.arange(k0, k0 + k_block, device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", qblk,
                             k[:, k0:k0 + k_block].float())
            s = _softcap(s, softcap)
            mask = (kpos < Sk_orig)[None, :].expand(q_block, k_block)
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            if seg_q is not None:
                mask = mask[None] & (seg_q[:, q0:q0 + q_block, None]
                                     == seg_k[:, None, k0:k0 + k_block])
            else:
                mask = mask[None]
            s = s.masked_fill(~mask[:, None], neg_inf)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            # fully-masked rows keep m = -inf: guard the exponents
            m_safe = torch.where(torch.isfinite(m_new), m_new,
                                 torch.zeros_like(m_new))
            p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]),
                            torch.zeros_like(s))
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                torch.zeros_like(m))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                v[:, k0:k0 + k_block].float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :Sq_orig]


def decode_attention(q, k_cache, v_cache, kv_len, *, softcap: float = 0.0,
                     window: int = 0) -> torch.Tensor:
    """Single-token ragged decode attention.

    q: (B, H, D); k/v_cache: (B, S, Kh, D); kv_len: (B,) valid lengths.
    As in the reference, q/sqrt(D) is rounded to the cache dtype and the
    products accumulate in f32 (exact products of the cache dtype).
    """
    B, H, D = q.shape
    S, Kh = k_cache.shape[1], k_cache.shape[2]
    G = H // Kh
    qf = (q / math.sqrt(D)).to(k_cache.dtype).reshape(B, Kh, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf.float(), k_cache.float())
    s = _softcap(s, softcap)
    pos = torch.arange(S, device=q.device)
    kv_len = kv_len.to(q.device)
    valid = pos[None, :] < kv_len[:, None]
    if window:
        valid &= pos[None, :] >= (kv_len[:, None] - window)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    m = torch.amax(s, dim=-1)                            # (B, Kh, G)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention module (projections)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg, dtype, device) -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Kh = cfg.num_heads, cfg.num_kv_heads
    sd = 1.0 / math.sqrt(d)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    p: Params = {
        "wq": (normal(d, H, hd) * sd).to(dtype),
        "wk": (normal(d, Kh, hd) * sd).to(dtype),
        "wv": (normal(d, Kh, hd) * sd).to(dtype),
        "wo": (normal(H, hd, d) * sd
               / math.sqrt(2 * cfg.num_layers)).to(dtype),
    }
    if cfg.attn.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Kh, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Kh, hd), dtype=dtype, device=device)
    if cfg.attn.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def qkv_project(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,D), k/v (B,S,Kh,D); bias, qk-norm, rope.

    qk-norm uses rmsnorm's default eps (1e-6), not ``cfg.norm_eps``, as
    the reference does."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if "q_norm" in p:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.attn.rope_theta)
        k = apply_rope(k, positions, cfg.attn.rope_theta)
    return q, k, v


def attn_output(p: Params, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, d_ff: int, gated: bool,
             num_layers: int, dtype, device) -> Params:
    sd_in, sd_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff * 2 * num_layers)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    p = {"w_in": (normal(d, d_ff) * sd_in).to(dtype),
         "w_out": (normal(d_ff, d) * sd_out).to(dtype)}
    if gated:
        p["w_gate"] = (normal(d, d_ff) * sd_in).to(dtype)
    return p


def mlp(p: Params, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    """``act(x @ w_in) * (x @ w_gate) @ w_out`` — the reference's naming,
    the opposite of the ``act(gate) * up`` habit elsewhere."""
    h = x @ p["w_in"]
    if act == "silu":
        a = F.silu(h)
    elif act == "relu2":
        a = torch.square(F.relu(h))
    elif act == "gelu":
        a = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(act)
    if gated:
        a = a * (x @ p["w_gate"])
    return a @ p["w_out"]
