"""Dense decoder-only transformer (counterpart of
``repro/models/transformer.py``, non-pattern branch).

Parameters keep the reference's tree, with the stacked leading layer
axis: ``layers.attn.wq`` (L, d, H, hd), ``layers.mlp.w_in`` (L, d, ff),
``layers.ln1.scale`` (L, d), ...  The layer loop is a Python loop over
that axis (the reference scans it).

Two departures from the reference, both for eager execution:
* ``prefill`` computes the (B, S, V) logits only when asked
  (``return_logits``); the engine discards them, and under ``jit`` the
  reference's compiler drops them, but an eager run would pay for them
  (5 GB in bf16 for Qwen3-0.6B at B=8, S=2048).
* caches are written in place: ``prefill`` fills the cache it is given,
  ``decode_step`` writes the new token's K/V into the dense cache and
  ``decode_step_paged`` straight into the page pool, then each attends
  with its kernel.  The reference gathers a dense view of the pool,
  decodes it and scatters the written page back; the results are the
  same for fp pages.  For int8 pages, as in the reference, the attention
  reads the pool's rows at their old scale with the new row unquantised
  in its place, and only then is the written page requantised (see
  ``decode_step_paged``).

As in the reference, ``forward`` and the plain prefill attend blockwise
above ``FULL_ATTN_MAX_SEQ`` positions; on CUDA tensors the prefill is the
flash kernel at every width.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L

Params = Dict[str, Any]

ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0}

FULL_ATTN_MAX_SEQ = L.FULL_ATTN_MAX_SEQ   # above this, attend blockwise


def check_supported(cfg: ModelConfig) -> None:
    """The configs this module serves (the reference's non-pattern,
    rope branch of the dense family)."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    if cfg.attn.layer_pattern != "global":
        raise NotImplementedError("local/global layer patterns not ported")
    if cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(f"pos_embedding {cfg.pos_embedding!r}")


def layer(params: Params, i: int) -> Params:
    """Layer ``i``'s parameters out of the stacked tree (views)."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["layers"])


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights with the reference's scales (``jax.random`` and
    ``torch.Generator`` draw different numbers from one seed)."""
    dtype = cfg.param_dtype
    d = cfg.d_model
    blocks = []
    for _ in range(cfg.num_layers):
        blocks.append({
            "attn": L.init_attention(generator, cfg, dtype, device),
            "mlp": L.init_mlp(generator, d, cfg.d_ff, cfg.gated_mlp,
                              cfg.num_layers, dtype, device),
            "ln1": _init_norm(cfg, dtype, device),
            "ln2": _init_norm(cfg, dtype, device),
        })

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    params: Params = {
        "embed": (torch.randn((cfg.vocab_size, d), generator=generator,
                              device=device) / math.sqrt(d)).to(dtype),
        "layers": stack(blocks),
        "final_norm": _init_norm(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn(
            (d, cfg.vocab_size), generator=generator, device=device)
            / math.sqrt(d)).to(dtype)
    return params


def _init_norm(cfg, dtype, device):
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm_type != "rmsnorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if cfg.scale_embeddings:
        x = x * math.sqrt(cfg.d_model)
    return x


def head_weight(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """(d, V) head in the compute dtype; a tied head is ``embed.T``, a
    strided view (nothing is transposed in memory)."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return w.to(cfg.compute_dtype)


def lm_logits(params: Params, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    x = L.norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    logits = x @ head_weight(params, cfg)
    if cfg.logit_softcap > 0:
        logits = L._softcap(logits.float(), cfg.logit_softcap)
    return logits


def _block(bp: Params, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, attend) -> Tuple[torch.Tensor, ...]:
    h = L.norm(x, bp["ln1"], cfg.norm_type, cfg.norm_eps)
    q, k, v = L.qkv_project(bp["attn"], cfg, h, positions)
    x = x + L.attn_output(bp["attn"], attend(q, k, v))
    h = L.norm(x, bp["ln2"], cfg.norm_type, cfg.norm_eps)
    x = x + L.mlp(bp["mlp"], h, cfg.mlp_act, cfg.gated_mlp)
    return x, k, v


# ---------------------------------------------------------------------------
# Forward (scoring): full sequence -> logits, plain attention
# ---------------------------------------------------------------------------


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor):
    """Returns (logits (B, S, V), aux).  Attention is plain PyTorch, as in
    the reference's scoring path: ``full_attention`` up to
    ``FULL_ATTN_MAX_SEQ`` positions, ``blockwise_attention`` above (one
    score tile at a time; under autograd every tile is kept for the
    backward).  It is the independent check of the engine's kernel path,
    and the trainer's path."""
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    attention = (L.full_attention if S <= FULL_ATTN_MAX_SEQ
                 else L.blockwise_attention)

    def attend(q, k, v):
        return attention(q, k, v, causal=True,
                         window=cfg.attn.sliding_window,
                         softcap=cfg.attn.attn_softcap)

    for i in range(cfg.num_layers):
        x, _, _ = _block(layer(params, i), cfg, x, positions, attend)
    return lm_logits(params, cfg, x), dict(ZERO_AUX)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    """{"k", "v"}: (L, batch, max_len, Kh, D) zeros in ``dtype`` (the
    compute dtype by default).  The paged engine calls it with
    (num_pages, page_size) for its pool, in int8 for an int8 pool."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    return {n: torch.zeros(shape, dtype=dtype or cfg.compute_dtype,
                           device=device)
            for n in ("k", "v")}


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], prompt_lens: torch.Tensor,
            seg_ids: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            return_logits: bool = True):
    """tokens (B, S) right-padded.  Fills ``cache[:, :, :S]`` in place and
    returns (logits (B, S, V) or None, cache).  Padded positions are
    masked downstream via kv_len.

    Packed mode (``seg_ids`` given): each row holds several prompts back
    to back, ``seg_ids`` (B, S) the row-local segment (-1 for padding) and
    ``positions`` each token's position inside its segment.  Attention
    goes through ``ops.flash_attention`` (the kernel on CUDA)."""
    del prompt_lens
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[:2]
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if seg_ids is not None:
        seg_ids = seg_ids.to(torch.int32).contiguous()

    def attend(q, k, v):
        return ops.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), seg_ids=seg_ids,
                                   window=cfg.attn.sliding_window,
                                   softcap=cfg.attn.attn_softcap)

    for i in range(cfg.num_layers):
        x, k, v = _block(layer(params, i), cfg, x, positions, attend)
        cache["k"][i, :, :S] = k.to(cache["k"].dtype)
        cache["v"][i, :, :S] = v.to(cache["v"].dtype)
    logits = lm_logits(params, cfg, x) if return_logits else None
    return logits, cache


# ---------------------------------------------------------------------------
# Decode steps: one token per slot, written in place, then attended
# ---------------------------------------------------------------------------


def _decode_layers(params: Params, cfg: ModelConfig, token: torch.Tensor,
                   kv_len: torch.Tensor, attend_layer, return_hidden: bool):
    """The layer loop of both decode steps.  ``attend_layer(i, q, k, v)``
    writes layer ``i``'s new K/V and returns its attention (B, 1, H, D);
    the result is the logits (B, V) or the final-normed hidden (B, d)."""
    x = embed_tokens(params, cfg, token[:, None])
    positions = kv_len[:, None]
    for i in range(cfg.num_layers):
        x, _, _ = _block(layer(params, i), cfg, x, positions,
                         lambda q, k, v, i=i: attend_layer(i, q, k, v))
    if return_hidden:
        return L.norm(x[:, 0], params["final_norm"], cfg.norm_type,
                      cfg.norm_eps)
    return lm_logits(params, cfg, x[:, 0])


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], kv_len: torch.Tensor,
                return_hidden: bool = False):
    """Dense layout.  token (B,); cache {"k", "v"} (L, B, S, Kh, D);
    kv_len (B,) int32, the position of the new token (< S).

    Per layer, the new token's k/v are written in place at row ``kv_len``
    of the slot's rows (inactive slots have kv_len 0 and write their row
    0, as in the reference), then the dense decode kernel reads
    ``kv_len + 1`` rows.  Returns (logits (B, V) or the final-normed
    hidden (B, d) with ``return_hidden``, cache)."""
    kv_len = kv_len.to(torch.int32)
    b = torch.arange(token.shape[0], device=token.device)
    row = kv_len.long()
    n_valid = (kv_len + 1).contiguous()

    def attend_layer(i, q, k, v):
        kc, vc = cache["k"][i], cache["v"][i]
        kc[b, row] = k[:, 0].to(kc.dtype)
        vc[b, row] = v[:, 0].to(vc.dtype)
        o = ops.ragged_decode_attention(
            q[:, 0].contiguous(), kc, vc, n_valid,
            softcap=cfg.attn.attn_softcap, window=cfg.attn.sliding_window)
        return o[:, None]

    out = _decode_layers(params, cfg, token, kv_len, attend_layer,
                         return_hidden)
    return out, cache


def requantize_written_pages(pages: torch.Tensor, scales: torch.Tensor,
                             page: torch.Tensor, row: torch.Tensor,
                             new: torch.Tensor, dtype: torch.dtype) -> None:
    """Write each slot's new row into its int8 page, in place, as the
    reference engine does after its decode (``engine.py:563-574``): the
    page is dequantised to the compute dtype, the new row (B, Kh, D) is
    set at ``row``, and the page is requantised with a monotone scale
    ``max(old, amax(page) / 127)`` over all P rows, stale rows included,
    rounding half to even.  A page whose amax did not grow keeps its old
    cells exactly.  pages (N, P, Kh, D) int8; scales (N,) f32.

    ``amax * (1 / 127)``, not ``amax / 127``: the reference's decode is
    jitted, and XLA turns a division by a constant into a product with
    its f32 reciprocal, which can differ in the last bit."""
    b = torch.arange(page.shape[0], device=page.device)
    old = scales[page]
    view = (pages[page].float() * old[:, None, None, None]).to(dtype)
    view[b, row] = new.to(dtype)
    view = view.float()
    s = torch.maximum(old, view.abs().amax(dim=(1, 2, 3)) * (1.0 / 127.0))
    pages[page] = torch.clamp(torch.round(view / s[:, None, None, None]),
                              -127, 127).to(torch.int8)
    scales[page] = s


def decode_step_paged(params: Params, cfg: ModelConfig, token: torch.Tensor,
                      pool: Dict[str, torch.Tensor],
                      block_tables: torch.Tensor, kv_len: torch.Tensor,
                      return_hidden: bool = False,
                      scales: Optional[Dict[str, torch.Tensor]] = None):
    """token (B,); pool {"k", "v"} (L, N, P, Kh, D); block_tables (B, nb)
    int32; kv_len (B,) int32, the position of the new token.

    Per layer, the new token's k/v are written in place at row
    ``kv_len % P`` of page ``block_tables[b, kv_len // P]`` (exclusive to
    the slot: the engine's copy-on-write planning made it so; inactive
    slots have kv_len 0 and the garbage page 0), then the paged attention
    reads the pool with ``kv_len + 1`` rows.

    int8 pools come with ``scales`` {"k", "v"} (L, N) f32, one per
    (layer, page), in the reference's order: the int8 kernel attends over
    the pool's rows at their old scale with the new row unquantised in
    place of row ``kv_len`` (``k_new``/``v_new``), and only then is the
    written page requantised (``requantize_written_pages``, the
    reference's formula), as the reference engine attends over its
    dequantised view and requantises after the step.  In f32 the pool
    and the logits match the reference's (``tests/test_torch_model.py``);
    in bf16 the reference also rounds the dequantised view to bf16, the
    kernel keeps it in f32.

    Returns (logits (B, V) or the final-normed hidden (B, d) with
    ``return_hidden``, pool)."""
    P = pool["k"].shape[2]
    bt = block_tables.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32)
    b = torch.arange(token.shape[0], device=token.device)
    page = bt[b, (kv_len // P).long()].long()
    row = (kv_len % P).long()
    n_valid = (kv_len + 1).contiguous()

    def attend_layer(i, q, k, v):
        kp, vp = pool["k"][i], pool["v"][i]
        attn = dict(softcap=cfg.attn.attn_softcap,
                    window=cfg.attn.sliding_window)
        if scales is None:
            kp[page, row] = k[:, 0].to(kp.dtype)
            vp[page, row] = v[:, 0].to(vp.dtype)
            o = ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, bt,
                                           n_valid, **attn)
            return o[:, None]
        ks, vs = scales["k"][i], scales["v"][i]
        k_new = k[:, 0].to(q.dtype).contiguous()
        v_new = v[:, 0].to(q.dtype).contiguous()
        o = ops.paged_decode_attention(
            q[:, 0].contiguous(), kp, vp, bt, n_valid, k_scales=ks,
            v_scales=vs, k_new=k_new, v_new=v_new, **attn)
        requantize_written_pages(kp, ks, page, row, k_new, cfg.compute_dtype)
        requantize_written_pages(vp, vs, page, row, v_new, cfg.compute_dtype)
        return o[:, None]

    out = _decode_layers(params, cfg, token, kv_len, attend_layer,
                         return_hidden)
    return out, pool
