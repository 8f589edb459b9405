"""Zamba2-style hybrid (counterpart of ``repro/models/hybrid.py``,
[arXiv:2411.15242]): a Mamba2 backbone with one *shared* attention + MLP
block applied every ``attn_every`` SSM layers (one set of weights, each
application with its own KV cache).

Layout for L layers, k = attn_every: g = L // k groups of (k Mamba2
layers, then the shared block), then L - g*k tail Mamba2 layers.  The
tree and the cache keep the reference's keys and stacking:
``mamba_main`` (g, k, ...), ``mamba_tail`` (tail, ...), ``shared_attn``
(a dense block: ``attn``, ``mlp``, ``ln1``, ``ln2``); the cache has
``ssm_main`` (g, k, B, H, N, P) f32, ``conv_x_main``/``conv_bc_main``
(g, k, B, K-1, ...), ``attn_k``/``attn_v`` (g, B, max_len, Kh, D) and
the ``*_tail`` states (tail, B, ...).

Prompts are left-padded (``Model.padding_side == "left"``): a row's
tokens end at the last column, so every row's last token is at column
S - 1 and the states after the prefill are each prompt's own.  The
prefill masks the pads as the reference does (zero embeddings, each
block's update zeroed there), and beyond it, so that the states equal an
unpadded prefill's for any biases: the SSD input is zeroed at pads
(``ssm.mamba2_forward(valid=)``), and the shared attention masks pad keys
at every width (flash with the left-pad mask as segment ids: pads 0,
tokens 1; the plain version above ``FULL_ATTN_MAX_SEQ`` too, where the
reference's blockwise branch masks none).  Decode reads rows
``[kv_start, kv_len]`` of each application's cache.

Where the attention runs: ``prefill`` through ``ops.flash_attention``
(the kernel on CUDA), ``decode_step`` through
``ops.ragged_decode_attention`` with ``kv_start``, ``forward`` plain.
The recurrences are plain PyTorch, as the reference computes them
outside any Pallas kernel.  As in ``transformer.py``, ``prefill`` and
``decode_step`` write into the cache they are given, and ``prefill``
computes the (B, S, V) logits only when asked.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as TF

Params = Dict[str, Any]


def _layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    k = cfg.attn_every
    g = cfg.num_layers // k
    return g, k, cfg.num_layers - g * k


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights with the reference's scales and tree."""
    g, k, tail = _layout(cfg)
    dtype, d = cfg.param_dtype, cfg.d_model
    mamba = [S.init_mamba2(generator, cfg, dtype, device)
             for _ in range(cfg.num_layers)]

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)
    params: Params = {
        "embed": (normal(cfg.vocab_size, d) / math.sqrt(d)).to(dtype),
        "mamba_main": TF.stack([TF.stack(mamba[gi * k:(gi + 1) * k])
                                for gi in range(g)]),
        "shared_attn": TF.init_block(cfg, generator, dtype, device),
        "final_norm": TF.init_norm(cfg, dtype, device),
        "lm_head": (normal(d, cfg.vocab_size) / math.sqrt(d)).to(dtype),
    }
    if tail:
        params["mamba_tail"] = TF.stack(mamba[g * k:])
    return params


def _mamba_layers(params: Params, cfg: ModelConfig):
    """(cache key suffix, stacked index, layer params) in layer order,
    the shared block after each group's last: ``("main", (gi, j), p)``
    and ``("tail", (t,), p)``; a group's end is ``("attn", gi, None)``."""
    g, k, tail = _layout(cfg)
    for gi in range(g):
        for j in range(k):
            yield "main", (gi, j), TF.pick(params["mamba_main"], (gi, j))
        yield "attn", gi, None
    for t in range(tail):
        yield "tail", (t,), TF.pick(params["mamba_tail"], t)


def forward(params: Params, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, V) with plain attention (``full_attention`` up to
    ``FULL_ATTN_MAX_SEQ``, blockwise above), as the reference scores.
    With ``cfg.remat`` each group (its Mamba2 layers, then the shared
    block) is recomputed in the backward (``L.remat``); the tail layers
    are not, as in the reference."""
    x = TF.embed_tokens(params, cfg, tokens)
    B, T = x.shape[:2]
    positions = torch.arange(T, device=x.device).expand(B, T)
    attention = (L.full_attention if T <= TF.FULL_ATTN_MAX_SEQ
                 else L.blockwise_attention)
    g, k, tail = _layout(cfg)

    def group(x, gi):
        for j in range(k):
            x = x + S.mamba2_forward(TF.pick(params["mamba_main"], (gi, j)),
                                     cfg, x)
        x, _, _ = _shared_block(
            params["shared_attn"], cfg, x, positions,
            lambda q, k, v: attention(q, k, v, causal=True))
        return x

    body = L.remat(cfg, group)
    for gi in range(g):
        x = body(x, gi)
    for t in range(tail):
        x = x + S.mamba2_forward(TF.pick(params["mamba_tail"], t), cfg, x)
    return TF.lm_logits(params, cfg, x)


# ---------------------------------------------------------------------------
# Cache: SSM + conv state per Mamba2 layer, a KV cache per application
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    dtype = dtype or cfg.compute_dtype
    g, k, tail = _layout(cfg)
    d_inner, nheads, _ = S.mamba2_dims(cfg)
    s = cfg.ssm
    gN = 2 * s.ngroups * s.state_dim
    Kh, D = cfg.num_kv_heads, cfg.resolved_head_dim
    Kc = s.conv_width - 1

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    cache = {
        "ssm_main": zeros(g, k, batch, nheads, s.state_dim, s.head_dim,
                          dt=torch.float32),
        "conv_x_main": zeros(g, k, batch, Kc, d_inner),
        "conv_bc_main": zeros(g, k, batch, Kc, gN),
        "attn_k": zeros(g, batch, max_len, Kh, D),
        "attn_v": zeros(g, batch, max_len, Kh, D),
    }
    if tail:
        cache["ssm_tail"] = zeros(tail, batch, nheads, s.state_dim,
                                  s.head_dim, dt=torch.float32)
        cache["conv_x_tail"] = zeros(tail, batch, Kc, d_inner)
        cache["conv_bc_tail"] = zeros(tail, batch, Kc, gN)
    return cache


def _shared_block(bp: Params, cfg: ModelConfig, x, positions, attend,
                  keep=None):
    """The shared attention + MLP block (the dense block), its updates
    zeroed where ``keep`` (B, T, 1) is false; returns (x, k, v)."""
    def masked(y):
        return y if keep is None else torch.where(keep, y, 0)
    h = L.norm(x, bp["ln1"], cfg.norm_type, cfg.norm_eps)
    q, k, v = L.qkv_project(bp["attn"], cfg, h, positions)
    x = x + masked(L.attn_output(bp["attn"], attend(q, k, v)))
    h = L.norm(x, bp["ln2"], cfg.norm_type, cfg.norm_eps)
    x = x + masked(L.mlp(bp["mlp"], h, cfg.mlp_act, cfg.gated_mlp))
    return x, k, v


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], prompt_lens: torch.Tensor,
            return_logits: bool = True):
    """tokens (B, S) left-padded: row b's ``prompt_lens[b]`` tokens fill
    columns [S - len, S).  Fills every state of ``cache`` and the
    applications' ``attn_k``/``attn_v`` rows [0, S) in place (pad rows
    hold the K/V of a zero hidden state; decode masks them by
    ``kv_start``) and returns (logits (B, S, V) or None, cache).  Each
    row's states are those of its unpadded prompt (module docstring)."""
    x = TF.embed_tokens(params, cfg, tokens)
    B, T = x.shape[:2]
    lens = prompt_lens.to(x.device).long()
    positions = torch.arange(T, device=x.device)[None] - (T - lens)[:, None]
    valid = positions >= 0
    keep = valid[..., None]
    x = torch.where(keep, x, 0)
    positions = positions.clamp(min=0)
    seg = valid.to(torch.int32).contiguous()

    def attend(q, k, v):
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), seg_ids=seg)
    for kind, idx, mp in _mamba_layers(params, cfg):
        if kind == "attn":
            x, k, v = _shared_block(params["shared_attn"], cfg, x, positions,
                                    attend, keep)
            cache["attn_k"][idx, :, :T] = k.to(cache["attn_k"].dtype)
            cache["attn_v"][idx, :, :T] = v.to(cache["attn_v"].dtype)
            continue
        out, (st, (cx, cbc)) = S.mamba2_forward(
            mp, cfg, torch.where(keep, x, 0), return_state=True, valid=valid)
        x = x + torch.where(keep, out, 0)
        cache[f"ssm_{kind}"][idx] = st
        cache[f"conv_x_{kind}"][idx] = cx.to(cache[f"conv_x_{kind}"].dtype)
        cache[f"conv_bc_{kind}"][idx] = cbc.to(
            cache[f"conv_bc_{kind}"].dtype)
    logits = TF.lm_logits(params, cfg, x) if return_logits else None
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], kv_len: torch.Tensor,
                kv_start: Optional[torch.Tensor] = None):
    """token (B,); kv_len (B,) int32, the row the new token's K/V take in
    every application's cache (the SSM states encode the same history);
    ``kv_start`` (B,) int32, the first live row (the left pads' count;
    zeros when None).  The new token's position is ``kv_len -
    kv_start``.  Per application the new K/V row is written in place,
    then the dense decode kernel reads rows ``[kv_start, kv_len]``.
    Every state is updated in place.  Returns (logits (B, V), cache)."""
    kv_len = kv_len.to(torch.int32)
    kv_start = (torch.zeros_like(kv_len) if kv_start is None
                else kv_start.to(device=kv_len.device, dtype=torch.int32))
    kv_start = kv_start.contiguous()
    b = torch.arange(token.shape[0], device=token.device)
    row = kv_len.long()
    n_valid = (kv_len + 1).contiguous()
    positions = (kv_len - kv_start)[:, None]
    x = TF.embed_tokens(params, cfg, token[:, None])[:, 0]

    def attend_in(kc, vc):
        def attend(q, k, v):
            kc[b, row] = k[:, 0].to(kc.dtype)
            vc[b, row] = v[:, 0].to(vc.dtype)
            return ops.ragged_decode_attention(
                q[:, 0].contiguous(), kc, vc, n_valid,
                kv_start=kv_start)[:, None]
        return attend
    for kind, idx, mp in _mamba_layers(params, cfg):
        if kind == "attn":
            h, _, _ = _shared_block(
                params["shared_attn"], cfg, x[:, None], positions,
                attend_in(cache["attn_k"][idx], cache["attn_v"][idx]))
            x = h[:, 0]
            continue
        ssm, cvx, cvbc = (cache[f"{n}_{kind}"] for n in ("ssm", "conv_x",
                                                         "conv_bc"))
        out, st, (cx, cbc) = S.mamba2_decode(mp, cfg, x, ssm[idx],
                                             (cvx[idx], cvbc[idx]))
        x = x + out
        ssm[idx] = st
        cvx[idx] = cx.to(cvx.dtype)
        cvbc[idx] = cbc.to(cvbc.dtype)
    return TF.lm_logits(params, cfg, x), cache
