"""Shared model building blocks (counterpart of ``repro/models/layers.py``):
norms, rotary and sinusoidal position embeddings, plain attention (full
and blockwise), projections, MLP, and ``remat`` for the models' layer
groups.

Plain functions on tensors and dicts of parameters, in the reference's
layouts: q (B, S, H, D), k/v (B, S, Kh, D), ``wq`` (d, H, hd), ``wo``
(H, hd, d).  Rounding follows the reference: norms and rope in f32,
attention scores and softmax in f32, products of the working dtype
accumulated in f32.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.distributed import sharding as SH

Params = Dict[str, torch.Tensor]


def remat(cfg, body: Callable) -> Callable:
    """``body`` (one layer group of a forward), recomputed in the backward
    instead of keeping its activations when ``cfg.remat`` is set and
    autograd records, as the reference wraps its scan body in
    ``jax.checkpoint``; ``body`` itself otherwise (prefill, decode and any
    ``no_grad`` forward are unchanged).  The values and gradients are the
    same either way."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return body

    def checkpointed(*args):
        return torch.utils.checkpoint.checkpoint(body, *args,
                                                 use_reentrant=False)
    return checkpointed


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
    """The residual's norm; under a split of its d over the embed axis
    (``decode_2d``, ``sharding.embed_axis``) an RMSNorm sums its squares
    over the axis and cuts its scale to the rank's block of d."""
    ax = SH.embed_axis()
    if ax is not None:
        if kind != "rmsnorm":
            raise NotImplementedError(f"{kind} over a split d")
        return _split_rmsnorm(x, p["scale"], eps, x.shape[-1] * ax.size)
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"], eps)
    return layernorm(x, p["scale"], p["bias"], eps)


def _split_rmsnorm(x, scale, eps: float, d: int):
    """``rmsnorm`` of the rank's block of a residual of width ``d``: the
    block's sum of squares summed over the embed axis, then / d."""
    dt = x.dtype
    x = x.float()
    var = SH.contract((x * x).sum(dim=-1, keepdim=True)) / d
    return ((x * torch.rsqrt(var + eps))
            * SH.embed_block(scale).float()).to(dt)


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


def sinusoidal_embedding(length: int, d: int, device=None) -> torch.Tensor:
    """(length, d) f32: sin at even columns, cos at odd ones, of position
    times 10000^(-2i/d) (whisper's encoder positions)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    emb = torch.zeros((length, d), dtype=torch.float32, device=device)
    emb[:, 0::2] = torch.sin(pos * div)
    emb[:, 1::2] = torch.cos(pos * div)
    return emb


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
                     window: int = 0, kv_start=None, cache_offset: int = 0,
                     combine_axis=None, return_lse: bool = False):
    """Single-token ragged decode attention.

    q: (B, H, D); k/v_cache: (B, S, Kh, D); kv_len: (B,) valid lengths;
    ``kv_start``: (B,) first valid row (left-padded prefills), so rows
    ``[kv_start, kv_len)`` are attended (zeros where none is).
    As in the reference, q/sqrt(D) is rounded to the cache dtype and the
    products accumulate in f32 (exact products of the cache dtype).

    ``cache_offset``: the global position of cache row 0 (a rank's block
    of a cache whose sequence axis is split over a mesh axis).
    ``combine_axis``: that mesh axis (a name of the ``DeviceMesh`` of the
    installed ``axis_rules``): the running max is taken over its ranks,
    then the sums and the accumulators are added over them (the
    reference's ``pmax`` and ``psum``, in rank order), so every rank
    returns the attention over all its ranks' rows.  ``return_lse``: also
    each head's log-sum-exp (B, H) f32 of its scores over the attended
    rows, -inf where a slot has none.
    """
    B, H, D = q.shape
    S, Kh = k_cache.shape[1], k_cache.shape[2]
    G = H // Kh
    qf = (q / math.sqrt(D)).to(k_cache.dtype).reshape(B, Kh, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qf.float(), k_cache.float())
    s = _softcap(s, softcap)
    pos = cache_offset + torch.arange(S, device=q.device)
    kv_len = kv_len.to(q.device)
    valid = pos[None, :] < kv_len[:, None]
    if kv_start is not None:
        valid &= pos[None, :] >= kv_start.to(q.device)[:, None]
    if window:
        valid &= pos[None, :] >= (kv_len[:, None] - window)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    m = torch.amax(s, dim=-1)                            # (B, Kh, G)
    if combine_axis is not None:
        m = SH.axis_max(m, combine_axis)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe[..., None]),
                    torch.zeros_like(s))
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    if combine_axis is not None:
        l = SH.axis_sum(l, combine_axis)
        acc = SH.axis_sum(acc, combine_axis)
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(B, H, D)
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m_safe + torch.log(torch.clamp(l, min=1e-30)),
                      torch.full_like(l, float("-inf")))
    return out, lse.reshape(B, H)


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
    the reference does.

    Under a placement with a model axis (``distributed/sharding.py``), x
    is the column-parallel input (``sharding.enter_columns``), q holds
    the rank's block of the heads and k/v the KV heads of ``wk``/``wv``
    as the rank holds them (its block where the plan splits them, else
    all of them): the reference's ``heads``/``kv_heads`` constraints.
    With the embed axis (``decode_2d``) x is the rank's block of d and
    each product's partial sums are summed over the axis before the
    biases."""
    path = ("layers", "attn")
    wq = SH.weight(p["wq"], path + ("wq",), split=1, embed=0)
    wk = SH.weight(p["wk"], path + ("wk",), embed=0)
    wv = SH.weight(p["wv"], path + ("wv",), embed=0)
    q = SH.contract(torch.einsum("bsd,dhk->bshk", x, wq))
    k = SH.contract(torch.einsum("bsd,dhk->bshk", x, wk))
    v = SH.contract(torch.einsum("bsd,dhk->bshk", x, wv))
    if "bq" in p:
        q = q + SH.weight(p["bq"], path + ("bq",), split=0)
        k = k + SH.weight(p["bk"], path + ("bk",))
        v = v + SH.weight(p["bv"], path + ("bv",))
    if "q_norm" in p:
        q = rmsnorm(q, SH.shared(p["q_norm"]))
        k = rmsnorm(k, SH.shared(p["k_norm"]))
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, positions, cfg.attn.rope_theta)
        k = apply_rope(k, positions, cfg.attn.rope_theta)
    return q, k, v


def attn_output(p: Params, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, H or the rank's heads, D) -> (B, S, d), laid out as the
    residual (``("batch", "seq", "embed")``: a row-parallel product's
    partial sums reduced over the model axis)."""
    wo = SH.weight(p["wo"], ("layers", "attn", "wo"), split=0, embed=2)
    out = torch.einsum("bshk,hkd->bsd", o, wo)
    return SH.logical_constraint(out, ("batch", "seq", "embed"),
                                 partial=SH.model_axis() is not None)


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
    the opposite of the ``act(gate) * up`` habit elsewhere.  Under a
    placement with a model axis the rank's FFN columns (the reference's
    ``ffn`` constraint), the output laid out as the residual (with the
    embed axis, the rank's block of d, as in ``qkv_project``)."""
    path = ("layers", "mlp")
    h = SH.contract(x @ SH.weight(p["w_in"], path + ("w_in",), split=1,
                                  embed=0))
    if act == "silu":
        a = F.silu(h)
    elif act == "relu2":
        a = torch.square(F.relu(h))
    elif act == "gelu":
        a = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    else:
        raise ValueError(act)
    if gated:
        a = a * SH.contract(x @ SH.weight(p["w_gate"], path + ("w_gate",),
                                          split=1, embed=0))
    out = a @ SH.weight(p["w_out"], path + ("w_out",), split=0, embed=1)
    return SH.logical_constraint(out, ("batch", "seq", "embed"),
                                 partial=SH.model_axis() is not None)
