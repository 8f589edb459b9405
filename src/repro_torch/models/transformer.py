"""Decoder-only transformer of the dense, MoE and vision-language families
(counterpart of ``repro/models/transformer.py``).

Parameters keep the reference's tree, with the stacked leading layer
axis: ``layers.attn.wq`` (L, d, H, hd), ``layers.mlp.w_in`` (L, d, ff),
``layers.ln1.scale`` (L, d), ...  The gemma2 local/global pattern stacks
layer pairs as the reference does, (L/2, 2, ...): sub-layer 0 of a group
is local (sliding window, ring cache), sub-layer 1 global.  The layer
loop is a Python loop over the layers (the reference scans the groups).

The MoE family is this backbone with ``mlp`` replaced by the expert
layer (``repro_torch/models/moe.py``: the reference's ``moe_mlp_dense``,
or ``moe_mlp_ep`` over a mesh when the caller passes its ``mlp_fn``):
each block's MLP returns (y, aux), and ``forward`` returns the router
losses summed over the layers.  The MoE sees exactly the tokens the
reference's calls give it, which set its capacity and so its drops: the
whole (B, S) batch in ``forward`` and ``prefill`` (the engine's bucketed
wave, pad rows and columns included), every slot in a decode step.
Prefill and decode discard the router losses and skip computing them.

The vision-language family is the dense backbone fed ``embeds``: its
stub frontend's patch rows, then the tokens' embeddings, one sequence at
positions ``arange(S)`` (``forward``, ``prefill``); decode is the dense
family's, with the patch rows in the cache before the tokens' rows.

The pattern's cache has the reference's four keys: ``k_local``/
``v_local`` (L/2, B, W, Kh, D), a ring of W = min(window, max_len) rows
where position p lives at row p % W, and ``k_global``/``v_global``
(L/2, B, max_len, Kh, D).  Its prefill fills each row's ring from that
row's ``prompt_lens`` (the last W positions of the prompt).  The
reference fills it from the last W columns of the padded width, which
puts pad rows into the ring of a prompt shorter than a prefill wider
than W; the two agree wherever the reference's decode equals its
forward (width <= W, or rows as long as the width).

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
from repro_torch.distributed import collectives as COL
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

Params = Dict[str, Any]

ZERO_AUX = {"load_balance": 0.0, "router_z": 0.0}

FULL_ATTN_MAX_SEQ = L.FULL_ATTN_MAX_SEQ   # above this, attend blockwise


def check_supported(cfg: ModelConfig) -> None:
    """The configs whose blocks this module serves: the reference's rope
    branch of the dense family, with either layer pattern, of the MoE
    family with the global pattern (no MoE config has another), of the
    vision-language family (the dense backbone behind stub patch rows)
    and of the hybrid family's shared block.  ``model.build_model``
    checks the family."""
    if cfg.attn.layer_pattern not in ("global", "local_global"):
        raise NotImplementedError(
            f"layer pattern {cfg.attn.layer_pattern!r}")
    if cfg.family == "moe" and cfg.attn.layer_pattern != "global":
        raise NotImplementedError(
            f"MoE with layer pattern {cfg.attn.layer_pattern!r}")
    if cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(f"pos_embedding {cfg.pos_embedding!r}")


def pattern_len(cfg: ModelConfig) -> int:
    return 2 if cfg.attn.layer_pattern == "local_global" else 1


def _sub_window(cfg: ModelConfig, j: int) -> int:
    """Sliding window for sub-layer j of a pattern group (0 = full attn)."""
    if cfg.attn.layer_pattern == "local_global":
        return cfg.attn.sliding_window if j == 0 else 0
    return cfg.attn.sliding_window


def pick(tree: Params, idx) -> Params:
    """Every leaf of a stacked tree indexed by ``idx`` (views)."""
    return {k: pick(v, idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


def layer(params: Params, i: int, cfg: ModelConfig) -> Params:
    """Layer ``i``'s parameters out of the stacked tree (views): sub-layer
    ``i % 2`` of group ``i // 2`` under the local/global pattern."""
    idx = (i // 2, i % 2) if pattern_len(cfg) == 2 else (i,)
    return pick(params["layers"], idx)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_block(cfg: ModelConfig, generator: torch.Generator, dtype,
               device) -> Params:
    """One block's {attn, mlp, ln1, ln2}; the MoE family's ``mlp`` is the
    expert layer's tree, its router f32."""
    attn = L.init_attention(generator, cfg, dtype, device)
    if cfg.family == "moe":
        mlp = MOE.init_moe_mlp(generator, cfg, dtype, device)
    else:
        mlp = L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                         cfg.num_layers, dtype, device)
    return {"attn": attn, "mlp": mlp,
            "ln1": init_norm(cfg, dtype, device),
            "ln2": init_norm(cfg, dtype, device)}


def stack(trees):
    """Trees of equal structure -> one tree of stacked leaves."""
    if isinstance(trees[0], dict):
        return {k: stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Params:
    """Random weights with the reference's scales (``jax.random`` and
    ``torch.Generator`` draw different numbers from one seed)."""
    dtype = cfg.param_dtype
    d = cfg.d_model
    blocks = [init_block(cfg, generator, dtype, device)
              for _ in range(cfg.num_layers)]
    if pattern_len(cfg) == 2:             # (L/2, 2, ...), as the reference
        blocks = [stack(blocks[i:i + 2]) for i in range(0, len(blocks), 2)]
    layers = stack(blocks)
    del blocks          # the unstacked copies, before the f32 draws below
    params: Params = {
        "embed": torch.randn((cfg.vocab_size, d), generator=generator,
                             device=device).div_(math.sqrt(d)).to(dtype),
        "layers": layers,
        "final_norm": init_norm(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(
            (d, cfg.vocab_size), generator=generator, device=device
        ).div_(math.sqrt(d)).to(dtype)
    return params


def init_norm(cfg, dtype, device):
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm_type != "rmsnorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor
                 ) -> torch.Tensor:
    """(B, S) ids -> (B, S, d) in the compute dtype.  Under a placement
    with a model axis, as the embedding's spec holds it: vocabulary rows
    split (a tied head) -> a lookup masked to the rank's rows, summed
    over the axis; the model dim split (an untied one) -> the rank's
    columns, gathered.  With the embed axis (``decode_2d``) the rows are
    then cut to the rank's block of d."""
    emb = params["embed"]
    ax = SH.model_axis()
    spec = SH.param_spec(("embed",), 2)
    if ax is not None and ax.name in SH.entry_axes(spec[0]):
        n = emb.shape[0]
        local = tokens.long() - ax.rank * n
        inside = (local >= 0) & (local < n)
        x = emb[local.clamp(0, n - 1)] * inside[..., None]
        x = COL.all_reduce(x, ax.group)
    elif ax is not None and ax.name in SH.entry_axes(spec[1]):
        x = COL.all_gather(emb[tokens.long()], ax.group, 2, grad="slice")
    else:
        x = emb[tokens.long()]
    x = SH.embed_block(x).to(cfg.compute_dtype)
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
    """Final norm, head, softcap.  Under a placement the head is the
    rank's block of it (``sharding.weight``): with the vocabulary split
    over the model axis the logits are the rank's block of the
    vocabulary, over the whole sequence; with the embed axis
    (``decode_2d``) x is the rank's block of d, the head's too, and the
    partial logits are summed over the axis before the softcap.  A
    vocabulary the model axis does not divide is computed whole on every
    rank of the axis (``sharding.vocab_split``)."""
    x = L.norm(x, SH.seq_shared(params["final_norm"]), cfg.norm_type,
               cfg.norm_eps)
    split = SH.vocab_split() is not None
    x = SH.enter_columns(x) if split else SH.gather_seq(x)
    if cfg.tie_embeddings:
        w = SH.weight(params["embed"], ("embed",),
                      split=0 if split else None, embed=1,
                      sum_model=split).T
    else:
        w = SH.weight(params["lm_head"], ("lm_head",),
                      split=1 if split else None, embed=0, sum_model=split)
    logits = SH.contract(x @ w.to(cfg.compute_dtype))
    if cfg.logit_softcap > 0:
        logits = L._softcap(logits.float(), cfg.logit_softcap)
    return logits


def mlp_fn(cfg: ModelConfig, with_aux: bool = True, ep_mesh=None,
           data_axes=("data",)):
    """``fn(params, h) -> (y, aux)``, the block's MLP on the normed
    residual ``h`` as the rank holds it (the reference's ``_apply_mlp``
    and ``_moe_mlp_fn``): the expert layer for the MoE family (aux None
    when ``with_aux`` is off), ``moe_mlp_ep`` over ``ep_mesh`` when one
    is given, else ``moe_mlp_dense``, each placed under a placement
    (``models/moe.py``); the dense MLP with ``ZERO_AUX`` for the other
    families, its columns over the model axis (``sharding.enter_columns``
    hands it the residual)."""
    if cfg.family == "moe" and ep_mesh is not None:
        return lambda p, h: MOE.moe_mlp_ep(p, cfg, h, ep_mesh,
                                           data_axes=data_axes,
                                           with_aux=with_aux)
    if cfg.family == "moe":
        return lambda p, h: MOE.moe_mlp_dense(p, cfg, h, with_aux=with_aux)
    return lambda p, h: (L.mlp(p, SH.enter_columns(h), cfg.mlp_act,
                               cfg.gated_mlp), dict(ZERO_AUX))


def _block(bp: Params, cfg: ModelConfig, x: torch.Tensor,
           positions: torch.Tensor, attend, mlp) -> Tuple[torch.Tensor, ...]:
    """Returns (x, k, v, aux): ``mlp`` is an ``mlp_fn``; ``attend(q, k,
    v)`` gets k/v with the KV heads the rank holds (``for_q`` picks those
    its query heads read).  Under a placement (``distributed/
    sharding.py``) x is the residual as the rank holds it (its block of
    the sequence under sequence parallelism) and the products run on the
    rank's heads and FFN columns (the MoE layers on their own blocks)."""
    h = L.norm(x, SH.seq_shared(bp["ln1"]), cfg.norm_type, cfg.norm_eps)
    q, k, v = L.qkv_project(bp["attn"], cfg, SH.enter_columns(h), positions)
    x = x + L.attn_output(bp["attn"], attend(q, k, v))
    h = L.norm(x, SH.seq_shared(bp["ln2"]), cfg.norm_type, cfg.norm_eps)
    y, aux = mlp(bp["mlp"], h)
    return x + y, k, v, aux


def for_q(cfg: ModelConfig, k: torch.Tensor) -> torch.Tensor:
    """The KV heads of ``k`` (B, S, heads as the rank holds them, D) that
    the rank's query heads read (all of them without a model axis)."""
    lo, hi = SH.kv_heads_for_q(cfg.num_heads, cfg.num_kv_heads, k.shape[2])
    return k if (lo, hi) == (0, k.shape[2]) else k[:, :, lo:hi]


# ---------------------------------------------------------------------------
# Forward (scoring): full sequence -> logits, plain attention
# ---------------------------------------------------------------------------


def forward(params: Params, cfg: ModelConfig,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None, mlp=None):
    """Returns (logits (B, S, V), aux), aux the router losses summed over
    the layers (``ZERO_AUX`` for the dense family).  ``embeds`` (B, S, d)
    in the compute dtype replace the token embeddings (the vision-language
    family's patch rows followed by its tokens' embeddings); positions are
    ``arange(S)`` over them all.  Attention is plain
    PyTorch, as in the reference's scoring path: ``full_attention`` up to
    ``FULL_ATTN_MAX_SEQ`` positions, ``blockwise_attention`` above (one
    score tile at a time; under autograd every tile is kept for the
    backward).  It is the independent check of the engine's kernel path,
    and the trainer's path.  With ``cfg.remat`` each group of
    ``pattern_len`` layers (the reference's scan body, the aux sums
    included) is recomputed in the backward (``L.remat``).  ``mlp`` is
    the blocks' ``mlp_fn`` (``mlp_fn(cfg)`` when None)."""
    x = embed_tokens(params, cfg, tokens) if embeds is None else embeds
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    # the residual as the rank holds it (its block of the sequence under
    # sequence parallelism); positions are the whole sequence's
    x = SH.logical_constraint(x, ("batch", "seq", "embed"))
    attention = (L.full_attention if S <= FULL_ATTN_MAX_SEQ
                 else L.blockwise_attention)
    pl = pattern_len(cfg)
    mlp = mlp or mlp_fn(cfg)

    def group(x, aux_sum, gi):
        for i in range(gi * pl, (gi + 1) * pl):
            def attend(q, k, v, window=_sub_window(cfg, i % pl)):
                return attention(q, for_q(cfg, k), for_q(cfg, v),
                                 causal=True, window=window,
                                 softcap=cfg.attn.attn_softcap)
            x, _, _, aux = _block(layer(params, i, cfg), cfg, x, positions,
                                  attend, mlp)
            aux_sum = {n: aux_sum[n] + aux[n] for n in aux_sum}
        return x, aux_sum

    body = L.remat(cfg, group)
    aux_sum = dict(ZERO_AUX)
    for gi in range(cfg.num_layers // pl):
        x, aux_sum = body(x, aux_sum, gi)
    return lm_logits(params, cfg, x), aux_sum


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype: Optional[torch.dtype] = None
               ) -> Dict[str, torch.Tensor]:
    """{"k", "v"}: (L, batch, max_len, Kh, D) zeros in ``dtype`` (the
    compute dtype by default).  The paged engine calls it with
    (num_pages, page_size) for its pool, in int8 for an int8 pool.  The
    local/global pattern has the four keys of the module docstring."""
    Kh, D = cfg.num_kv_heads, cfg.resolved_head_dim
    dtype = dtype or cfg.compute_dtype

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)
    if pattern_len(cfg) == 2:
        G, W = cfg.num_layers // 2, min(cfg.attn.sliding_window, max_len)
        return {"k_local": zeros(G, batch, W, Kh, D),
                "v_local": zeros(G, batch, W, Kh, D),
                "k_global": zeros(G, batch, max_len, Kh, D),
                "v_global": zeros(G, batch, max_len, Kh, D)}
    return {n: zeros(cfg.num_layers, batch, max_len, Kh, D)
            for n in ("k", "v")}


def ring_fill_positions(prompt_lens: torch.Tensor, W: int, S: int
                        ) -> torch.Tensor:
    """(B, min(W, S)) prompt positions for ring rows [0, min(W, S)): row r
    of a prompt of n tokens takes its last position p < n with p % W ==
    r; a row no prompt position reaches (r >= n) takes position r, a pad
    column that decode overwrites before it reads the row."""
    r = torch.arange(min(W, S), device=prompt_lens.device)
    wraps = torch.div(prompt_lens.long()[:, None] - 1 - r, W,
                      rounding_mode="floor").clamp(min=0)
    return r + W * wraps


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: Dict[str, torch.Tensor], prompt_lens: torch.Tensor,
            seg_ids: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            return_logits: bool = True,
            embeds: Optional[torch.Tensor] = None, mlp=None):
    """tokens (B, S) right-padded.  Fills ``cache[:, :, :S]`` in place and
    returns (logits (B, S, V) or None, cache).  Padded positions are
    masked downstream via kv_len.  ``embeds`` (B, S', d) replace the token
    embeddings, as in ``forward``: the vision-language family passes its
    patch rows and then the tokens' embeddings, so S' rows are prefilled
    (the stub rows first) at positions ``arange(S')``.  Under the
    local/global pattern the global layers fill ``k_global``/``v_global``
    so, and the local layers each row's ring from its ``prompt_lens``
    (module docstring).

    Packed mode (``seg_ids`` given): each row holds several prompts back
    to back, ``seg_ids`` (B, S) the row-local segment (-1 for padding) and
    ``positions`` each token's position inside its segment; the pattern
    refuses it, as the reference does.  Attention goes through
    ``ops.flash_attention`` (the kernel on CUDA).  ``mlp`` is the blocks'
    ``mlp_fn`` (``mlp_fn(cfg, with_aux=False)`` when None)."""
    x = embed_tokens(params, cfg, tokens) if embeds is None else embeds
    B, S = x.shape[:2]
    pl = pattern_len(cfg)
    if pl == 2 and seg_ids is not None:
        raise ValueError("packed prefill: local/global not supported")
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    if seg_ids is not None:
        seg_ids = seg_ids.to(torch.int32).contiguous()
    if pl == 2:
        W = cache["k_local"].shape[2]
        ring = ring_fill_positions(prompt_lens.to(x.device), W, S)
        ring = ring[:, :, None, None].expand(
            B, ring.shape[1], cache["k_local"].shape[3],
            cfg.resolved_head_dim)

    mlp = mlp or mlp_fn(cfg, with_aux=False)
    for i in range(cfg.num_layers):
        def attend(q, k, v, window=_sub_window(cfg, i % pl)):
            return ops.flash_attention(q.contiguous(),
                                       for_q(cfg, k).contiguous(),
                                       for_q(cfg, v).contiguous(),
                                       seg_ids=seg_ids,
                                       window=window,
                                       softcap=cfg.attn.attn_softcap)
        x, k, v, _ = _block(layer(params, i, cfg), cfg, x, positions, attend,
                            mlp)
        if pl == 1:
            kc, vc = cache["k"][i], cache["v"][i]
        else:
            kind = "local" if i % 2 == 0 else "global"
            kc, vc = cache[f"k_{kind}"][i // 2], cache[f"v_{kind}"][i // 2]
        if pl == 2 and i % 2 == 0:
            n = ring.shape[1]
            kc[:, :n] = torch.gather(k, 1, ring).to(kc.dtype)
            vc[:, :n] = torch.gather(v, 1, ring).to(vc.dtype)
        else:
            kc[:, :S] = k.to(kc.dtype)
            vc[:, :S] = v.to(vc.dtype)
    logits = lm_logits(params, cfg, x) if return_logits else None
    return logits, cache


# ---------------------------------------------------------------------------
# Decode steps: one token per slot, written in place, then attended
# ---------------------------------------------------------------------------


def _decode_layers(params: Params, cfg: ModelConfig, token: torch.Tensor,
                   kv_len: torch.Tensor, attend_layer, return_hidden: bool,
                   mlp=None):
    """The layer loop of the decode steps.  ``attend_layer(i, q, k, v)``
    writes layer ``i``'s new K/V and returns its attention (B, 1, H, D);
    the result is the logits (B, V) or the final-normed hidden (B, d).
    ``mlp`` is the blocks' ``mlp_fn`` (without aux when None)."""
    x = embed_tokens(params, cfg, token[:, None])
    positions = kv_len[:, None]
    mlp = mlp or mlp_fn(cfg, with_aux=False)
    for i in range(cfg.num_layers):
        x, _, _, _ = _block(layer(params, i, cfg), cfg, x, positions,
                            lambda q, k, v, i=i: attend_layer(i, q, k, v),
                            mlp)
    if return_hidden:
        return L.norm(x[:, 0], params["final_norm"], cfg.norm_type,
                      cfg.norm_eps)
    return lm_logits(params, cfg, x[:, 0])


def cache_attend(cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                 name: str, row: torch.Tensor, live: torch.Tensor,
                 window: int = 0):
    """``attend(q, k, v, kc, vc)`` for the layers of cache leaf ``name``
    (``kc``/``vc`` a layer's (B, S, Kh, D) of it): each slot's new k/v
    written at ``row`` (B,) of its slot, then the first ``live`` (B,) rows
    attended through the dense decode kernel; returns (B, 1, heads, D),
    the heads as the rank's q holds them.

    Under a placement the cache is the rank's block of it (``distributed/
    sharding.py``): its rows split over ``cache_seq_axes`` (rows [off,
    off + S_l): a new row is written only where it falls there, the
    block's live rows are attended with the kernel's lse and the ranks'
    outputs combined over the axes, ``combine_over``), its slots split
    over axes the activations' rows are not (``cache_slot_axes``:
    ``decode_2d``'s ``data``; the rank's block of the slots written and
    attended, the outputs gathered over them).  Every query head reads
    every block of rows, so query heads split over the model axis are
    gathered for the kernel and the combined output cut back to the
    rank's heads.  Where the cache's rows and slots are whole, the rank's
    query heads attend only the KV heads they read (``for_q``; all of
    them where the cache's KV heads are split as the query heads).  A
    window is applied by the unsplit path only."""
    seq_axes = SH.cache_seq_axes(name)
    slot_axes = SH.cache_slot_axes(name)
    attn = dict(softcap=cfg.attn.attn_softcap, window=window)
    if not (seq_axes or slot_axes):
        b = torch.arange(row.shape[0], device=row.device)
        live = live.to(torch.int32).contiguous()

        def attend(q, k, v, kc, vc):
            kc[b, row] = k[:, 0].to(kc.dtype)
            vc[b, row] = v[:, 0].to(vc.dtype)
            return ops.ragged_decode_attention(
                q[:, 0].contiguous(), for_q(cfg, kc).contiguous(),
                for_q(cfg, vc).contiguous(), live, **attn)[:, None]
        return attend
    if window:
        raise NotImplementedError(
            "decode over a split cache with a window")
    heads = SH.model_axis()
    heads = (heads,) if heads is not None else ()
    row = SH.block_over(row, slot_axes)
    S_l = cache[name].shape[2]
    off = SH.block_index(seq_axes) * S_l
    mine = (row >= off) & (row < off + S_l)
    b = torch.arange(row.shape[0], device=row.device)[mine]
    r = row[mine] - off
    n_valid = (SH.block_over(live, slot_axes) - off).clamp(0, S_l)
    n_valid = n_valid.to(torch.int32).contiguous()

    def attend(q, k, v, kc, vc):
        kn = SH.block_over(k[:, 0], slot_axes)
        vn = SH.block_over(v[:, 0], slot_axes)
        if kn.shape[1] != kc.shape[2]:
            raise NotImplementedError(
                "decode over a split cache from KV heads split over the "
                "model axis")
        kc[b, r] = kn[mine].to(kc.dtype)
        vc[b, r] = vn[mine].to(vc.dtype)
        q0 = SH.gather_over(q[:, 0], heads, dim=1)
        q0 = SH.block_over(q0, slot_axes).contiguous()
        o, lse = ops.ragged_decode_attention(q0, kc, vc, n_valid,
                                             return_lse=True, **attn)
        o = SH.gather_over(SH.combine_over(o, lse, seq_axes), slot_axes)
        return SH.block_over(o, heads, dim=1)[:, None]
    return attend


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], kv_len: torch.Tensor,
                return_hidden: bool = False, mlp=None):
    """Dense layout.  token (B,); cache {"k", "v"} (L, B, S, Kh, D);
    kv_len (B,) int32, the position of the new token (< S).

    Per layer, the new token's k/v are written in place at row ``kv_len``
    of the slot's rows (inactive slots have kv_len 0 and write their row
    0, as in the reference), then the dense decode kernel reads
    ``kv_len + 1`` rows (``cache_attend``: under a placement, the rank's
    block of the cache, combined over the ranks).  Returns (logits (B, V)
    or the final-normed hidden (B, d) with ``return_hidden``, cache)."""
    if pattern_len(cfg) == 2:
        raise ValueError("use decode_step_pattern for local/global archs")
    kv_len = kv_len.to(torch.int32)
    attend = cache_attend(cfg, cache, "k", kv_len.long(), kv_len + 1,
                          window=cfg.attn.sliding_window)

    def attend_layer(i, q, k, v):
        return attend(q, k, v, cache["k"][i], cache["v"][i])

    out = _decode_layers(params, cfg, token, kv_len, attend_layer,
                         return_hidden, mlp)
    return out, cache


def decode_step_pattern(params: Params, cfg: ModelConfig,
                        token: torch.Tensor, cache: Dict[str, torch.Tensor],
                        kv_len: torch.Tensor):
    """Decode of the local/global pattern (gemma2) over its four-key
    cache, as the reference's ``decode_step_pattern``: a local layer
    writes its ring at row ``kv_len % W`` and attends ``min(kv_len + 1,
    W)`` ring rows (the ring holds exactly the window's positions, so no
    window is applied), a global layer writes row ``kv_len`` and attends
    ``kv_len + 1`` rows; both through the dense decode kernel with the
    attention softcap (``cache_attend``: under a placement each rank
    holds a block of the ring's rows and of the global rows, W the whole
    ring's).  Returns (logits (B, V), cache)."""
    kv_len = kv_len.to(torch.int32)
    W = cache["k_local"].shape[2] * math.prod(
        a.size for a in SH.cache_seq_axes("k_local"))
    local = cache_attend(cfg, cache, "k_local", (kv_len % W).long(),
                         torch.clamp(kv_len + 1, max=W))
    glob = cache_attend(cfg, cache, "k_global", kv_len.long(), kv_len + 1)

    def attend_layer(i, q, k, v):
        kind = "local" if i % 2 == 0 else "global"
        return (local if kind == "local" else glob)(
            q, k, v, cache[f"k_{kind}"][i // 2], cache[f"v_{kind}"][i // 2])

    return _decode_layers(params, cfg, token, kv_len, attend_layer,
                          False), cache


def decode(params: Params, cfg: ModelConfig, token: torch.Tensor,
           cache: Dict[str, torch.Tensor], kv_len: torch.Tensor,
           return_hidden: bool = False, mlp=None):
    """The dense layout's decode step of either pattern (the reference's
    ``decode``); ``mlp`` reaches the global pattern's blocks (the MoE
    family has no other)."""
    if pattern_len(cfg) == 2:
        if return_hidden:
            raise ValueError("return_hidden: local/global not supported")
        return decode_step_pattern(params, cfg, token, cache, kv_len)
    return decode_step(params, cfg, token, cache, kv_len,
                       return_hidden=return_hidden, mlp=mlp)


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

    Inactive slots all write row 0 of the garbage page, so on fp pages
    each reads back whichever slot wrote last, where the reference's
    slot attends its own new row.  Their outputs are discarded, but in
    the MoE family every slot's hidden state takes expert capacity from
    the others, so there a row with ``kv_len == 0`` (one row to attend:
    softmax weight exactly 1) takes its own new V row, which is what the
    kernel returns for such a row when no other slot shares its page.
    int8 pages attend the new rows ``k_new``/``v_new`` and need nothing.

    Returns (logits (B, V) or the final-normed hidden (B, d) with
    ``return_hidden``, pool)."""
    if pattern_len(cfg) == 2:
        raise ValueError("paged decode: local/global not supported")
    P = pool["k"].shape[2]
    bt = block_tables.to(torch.int32).contiguous()
    kv_len = kv_len.to(torch.int32)
    b = torch.arange(token.shape[0], device=token.device)
    page = bt[b, (kv_len // P).long()].long()
    row = (kv_len % P).long()
    n_valid = (kv_len + 1).contiguous()
    own_row = ((kv_len == 0)[:, None, None]
               if cfg.family == "moe" and scales is None else None)

    def attend_layer(i, q, k, v):
        kp, vp = pool["k"][i], pool["v"][i]
        attn = dict(softcap=cfg.attn.attn_softcap,
                    window=cfg.attn.sliding_window)
        if scales is None:
            kp[page, row] = k[:, 0].to(kp.dtype)
            vp[page, row] = v[:, 0].to(vp.dtype)
            o = ops.paged_decode_attention(q[:, 0].contiguous(), kp, vp, bt,
                                           n_valid, **attn)
            if own_row is not None:
                own = v[:, 0].to(vp.dtype).repeat_interleave(
                    cfg.q_per_kv, dim=1).to(o.dtype)
                o = torch.where(own_row, own, o)
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
