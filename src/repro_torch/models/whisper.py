"""Whisper-style encoder-decoder (counterpart of ``repro/models/whisper.py``,
[arXiv:2212.04356]).

As in the reference, the mel-spectrogram and convolution frontend is a
stub: the encoder takes precomputed frame embeddings (B, T_enc, d).  The
transformer is whole: a bidirectional encoder with sinusoidal positions,
a causal decoder with learned positions and cross-attention to the
encoder's states, LayerNorm and GELU MLPs.

The parameter tree is the reference's: ``enc_layers`` and ``dec_layers``
stacked along a leading layer axis (a decoder block adds ``xattn`` and
``ln_x`` to the dense block), ``pos_embed`` (max_position, d),
``enc_norm``, ``final_norm``, ``embed`` and ``lm_head``.  The cache has
four keys: the decoder's own ``k``/``v`` (L, B, max_len, Kh, D) and the
cross K/V ``k_x``/``v_x`` (L, B, T_enc, Kh, D) of the encoder's rows,
which the prefill fills from the frames and every decode step reads
whole; a four-key cache takes the dense slot layout only.

Where the attention runs:
* the decoder's causal self-attention in ``prefill``: ``ops.flash_attention``
  (the kernel on CUDA);
* both attentions of ``decode_step``: ``ops.ragged_decode_attention``, the
  self-attention over ``kv_len + 1`` rows after the new row is written in
  place, the cross-attention over all T_enc rows of ``k_x``/``v_x``;
* the encoder's bidirectional attention and the prefill's
  cross-attention: plain ``layers.full_attention(causal=False)``, as the
  reference computes them outside any Pallas kernel (``blockwise_attention``
  above ``FULL_ATTN_MAX_SEQ`` encoder rows, as there);
* ``forward`` (scoring): plain attention throughout.

As in ``transformer.py``, ``prefill`` writes into the cache it is given
and computes the (B, S, V) logits only when asked.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights with the reference's scales and tree."""
    dtype = cfg.param_dtype
    d = cfg.d_model
    enc = [TF.init_block(cfg, generator, dtype, device)
           for _ in range(cfg.encoder_layers)]
    dec = []
    for _ in range(cfg.num_layers):
        b = TF.init_block(cfg, generator, dtype, device)
        b["xattn"] = L.init_attention(generator, cfg, dtype, device)
        b["ln_x"] = TF.init_norm(cfg, dtype, device)
        dec.append(b)

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)
    return {
        "embed": (normal(cfg.vocab_size, d) / math.sqrt(d)).to(dtype),
        "pos_embed": (normal(cfg.max_position, d) * 0.02).to(dtype),
        "enc_layers": TF.stack(enc),
        "dec_layers": TF.stack(dec),
        "enc_norm": TF.init_norm(cfg, dtype, device),
        "final_norm": TF.init_norm(cfg, dtype, device),
        "lm_head": (normal(d, cfg.vocab_size) / math.sqrt(d)).to(dtype),
    }


def _norm(cfg: ModelConfig, x, p):
    return L.norm(x, p, cfg.norm_type, cfg.norm_eps)


def _self_attention(q, k, v, causal: bool):
    attention = (L.full_attention if q.shape[1] <= TF.FULL_ATTN_MAX_SEQ
                 else L.blockwise_attention)
    return attention(q, k, v, causal=causal)


def encode(params: Params, cfg: ModelConfig,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T_enc, d) stub frame embeddings -> encoder states.
    With ``cfg.remat`` each block is recomputed in the backward."""
    B, T, _ = frames.shape
    x = frames.to(cfg.compute_dtype)
    x = x + L.sinusoidal_embedding(T, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(T, device=x.device).expand(B, T)

    def block(x, i):
        bp = TF.pick(params["enc_layers"], i)
        q, k, v = L.qkv_project(bp["attn"], cfg, _norm(cfg, x, bp["ln1"]),
                                positions)
        x = x + L.attn_output(bp["attn"], _self_attention(q, k, v, False))
        return x + L.mlp(bp["mlp"], _norm(cfg, x, bp["ln2"]), cfg.mlp_act,
                         cfg.gated_mlp)

    body = L.remat(cfg, block)
    for i in range(cfg.encoder_layers):
        x = body(x, i)
    return _norm(cfg, x, params["enc_norm"])


def cross_kv(params: Params, cfg: ModelConfig, enc_states: torch.Tensor):
    """Every decoder layer's cross-attention K/V of the encoder states:
    (k_x, v_x), each (L, B, T_enc, Kh, D)."""
    xa = params["dec_layers"]["xattn"]
    k = torch.einsum("bsd,ldhk->lbshk", enc_states, xa["wk"])
    v = torch.einsum("bsd,ldhk->lbshk", enc_states, xa["wv"])
    return k, v


def _dec_block(bp: Params, cfg: ModelConfig, x, positions, kx, vx, attend):
    """One decoder block: self-attention through ``attend(q, k, v)``, then
    cross-attention to (kx, vx) (B, T_enc, Kh, D), then the MLP.  Returns
    (x, k, v), k/v the block's own new rows."""
    q, k, v = L.qkv_project(bp["attn"], cfg, _norm(cfg, x, bp["ln1"]),
                            positions)
    x = x + L.attn_output(bp["attn"], attend(q, k, v))
    qx = torch.einsum("bsd,dhk->bshk", _norm(cfg, x, bp["ln_x"]),
                      bp["xattn"]["wq"])
    x = x + L.attn_output(bp["xattn"],
                          L.full_attention(qx, kx, vx, causal=False))
    x = x + L.mlp(bp["mlp"], _norm(cfg, x, bp["ln2"]), cfg.mlp_act,
                  cfg.gated_mlp)
    return x, k, v


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """Token embeddings plus the learned positions [0, S)."""
    x = TF.embed_tokens(params, cfg, tokens)
    return x + params["pos_embed"][:x.shape[1]][None].to(x.dtype)


def decoder_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    enc_states: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder pass over tokens (B, S): logits (B, S, V),
    plain attention.  With ``cfg.remat`` each block is recomputed in the
    backward."""
    x = _embed(params, cfg, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    k_x, v_x = cross_kv(params, cfg, enc_states)

    def block(x, kx, vx, i):
        return _dec_block(TF.pick(params["dec_layers"], i), cfg, x,
                          positions, kx, vx,
                          lambda q, k, v: _self_attention(q, k, v, True))[0]

    body = L.remat(cfg, block)
    for i in range(cfg.num_layers):
        x = body(x, k_x[i], v_x[i], i)
    return TF.lm_logits(params, cfg, x)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    return decoder_forward(params, cfg, tokens, encode(params, cfg, frames))


# ---------------------------------------------------------------------------
# Decode: self-attention cache + the encoder's cross K/V
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    dtype = dtype or cfg.compute_dtype
    Kh, D = cfg.num_kv_heads, cfg.resolved_head_dim
    L_, T = cfg.num_layers, cfg.encoder_positions

    def zeros(rows):
        return torch.zeros((L_, batch, rows, Kh, D), dtype=dtype,
                           device=device)
    return {"k": zeros(max_len), "v": zeros(max_len),
            "k_x": zeros(T), "v_x": zeros(T)}


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], prompt_lens: torch.Tensor,
            frames: Optional[torch.Tensor] = None,
            return_logits: bool = True):
    """Encodes ``frames`` into the cache's cross K/V (when given), then
    prefills the right-padded decoder prompts tokens (B, S): fills
    ``cache["k"|"v"][:, :, :S]`` in place and returns (logits (B, S, V) or
    None, cache).  Padded positions are masked downstream via kv_len."""
    del prompt_lens
    if frames is not None:
        k_x, v_x = cross_kv(params, cfg, encode(params, cfg, frames))
        cache["k_x"].copy_(k_x)
        cache["v_x"].copy_(v_x)
        del k_x, v_x
    x = _embed(params, cfg, tokens)
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)

    def attend(q, k, v):
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous())
    for i in range(cfg.num_layers):
        x, k, v = _dec_block(TF.pick(params["dec_layers"], i), cfg, x,
                             positions, cache["k_x"][i], cache["v_x"][i],
                             attend)
        cache["k"][i, :, :S] = k.to(cache["k"].dtype)
        cache["v"][i, :, :S] = v.to(cache["v"].dtype)
    logits = TF.lm_logits(params, cfg, x) if return_logits else None
    return logits, cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], kv_len: torch.Tensor):
    """token (B,); kv_len (B,) int32, the new token's position.  Per layer
    the new K/V row is written in place at row ``kv_len`` and the
    self-attention reads ``kv_len + 1`` rows, the cross-attention all
    T_enc rows, both through the dense decode kernel.  Returns (logits
    (B, V), cache)."""
    kv_len = kv_len.to(torch.int32)
    b = torch.arange(token.shape[0], device=token.device)
    row = kv_len.long()
    n_self = (kv_len + 1).contiguous()
    n_cross = torch.full_like(kv_len, cache["k_x"].shape[2])
    x = TF.embed_tokens(params, cfg, token[:, None])
    x = x + params["pos_embed"][row][:, None].to(x.dtype)
    for i in range(cfg.num_layers):
        bp = TF.pick(params["dec_layers"], i)
        q, k, v = L.qkv_project(bp["attn"], cfg, _norm(cfg, x, bp["ln1"]),
                                kv_len[:, None])
        kc, vc = cache["k"][i], cache["v"][i]
        kc[b, row] = k[:, 0].to(kc.dtype)
        vc[b, row] = v[:, 0].to(vc.dtype)
        o = ops.ragged_decode_attention(q[:, 0].contiguous(), kc, vc, n_self)
        x = x + L.attn_output(bp["attn"], o[:, None])
        qx = torch.einsum("bsd,dhk->bshk", _norm(cfg, x, bp["ln_x"]),
                          bp["xattn"]["wq"])
        ox = ops.ragged_decode_attention(qx[:, 0].contiguous(),
                                         cache["k_x"][i], cache["v_x"][i],
                                         n_cross)
        x = x + L.attn_output(bp["xattn"], ox[:, None])
        x = x + L.mlp(bp["mlp"], _norm(cfg, x, bp["ln2"]), cfg.mlp_act,
                      cfg.gated_mlp)
    return TF.lm_logits(params, cfg, x[:, 0]), cache
