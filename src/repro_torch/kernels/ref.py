"""Plain PyTorch versions of the kernels (counterpart of
``repro/kernels/ref.py``).  The wrappers use them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers as L

# Tolerance of int8 KV pages, the port's own copy of the reference's
# documented bound: max abs error of the paged decode attention OUTPUT
# over int8 pages (per-page symmetric scale, amax / 127) against the fp
# decode over the same K/V.
KV_INT8_DECODE_ATOL = 0.05


def ragged_decode_attention_ref(q, k_cache, v_cache, kv_len,
                                softcap: float = 0.0, window: int = 0
                                ) -> torch.Tensor:
    """(B, H, D) x (B, S, Kh, D) x (B,) -> (B, H, D)."""
    return L.decode_attention(q, k_cache, v_cache, kv_len, softcap=softcap,
                              window=window)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """Dense per-slot view of a paged pool.

    pages: (N, page, Kh, D); block_tables: (B, nb) -> (B, nb*page, Kh, D).
    """
    B, nb = block_tables.shape
    g = pages[block_tables.reshape(-1).long()]
    return g.reshape(B, nb * pages.shape[1], *pages.shape[2:])


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, kv_len,
                               softcap: float = 0.0, window: int = 0
                               ) -> torch.Tensor:
    """(B, H, D) x (N, page, Kh, D) x (B, nb) x (B,) -> (B, H, D)."""
    return L.decode_attention(q, gather_pages(k_pages, block_tables),
                              gather_pages(v_pages, block_tables),
                              kv_len, softcap=softcap, window=window)


def quantize_pages_ref(pages: torch.Tensor):
    """Per-page symmetric int8 quantization: (N, page, Kh, D) fp ->
    (int8 pages, (N,) f32 scales) with scale = amax / 127 (1e-8 floor, so
    all-zero pages round-trip exactly).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    x = pages.float()
    amax = x.abs().amax(dim=(1, 2, 3))
    scales = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scales[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scales


def dequantize_pages_ref(pages: torch.Tensor, scales: torch.Tensor
                         ) -> torch.Tensor:
    """(N, page, Kh, D) int8 x (N,) f32 -> f32 pages."""
    return pages.float() * scales.float()[:, None, None, None]


def paged_decode_attention_int8_ref(q, k_pages, v_pages, k_scales, v_scales,
                                    block_tables, kv_len,
                                    softcap: float = 0.0, window: int = 0,
                                    k_new=None, v_new=None) -> torch.Tensor:
    """int8 pages: gather each slot's pages, dequantise them to f32 by
    their page's scale, then the plain decode in f32 (the output takes
    q's dtype).

    ``k_new``/``v_new`` (B, Kh, D), in q's dtype: the slot's new row,
    unquantised, read in place of row ``len - 1`` (``len = min(kv_len,
    nb * P)``), as the reference engine attends over the row it has just
    set in its dequantised view and requantises the page only after the
    step (``repro/rollout/engine.py``, ``_paged_decode_fn``).  The view
    stays f32, as the CUDA kernel keeps it (and the Pallas int8 body);
    the reference engine rounds it to the compute dtype first, which in
    f32 (the CPU parity tests) is the same value."""
    if (k_new is None) != (v_new is None):
        raise ValueError("pass both k_new and v_new or neither")
    views = [gather_pages(dequantize_pages_ref(p, s), block_tables)
             for p, s in ((k_pages, k_scales), (v_pages, v_scales))]
    if k_new is not None:
        S = views[0].shape[1]
        last = torch.clamp(kv_len.long().to(q.device), max=S) - 1
        has = torch.nonzero(last >= 0)[:, 0]
        for g, new in zip(views, (k_new, v_new)):
            g[has, last[has]] = new[has].float()
    return L.decode_attention(q, views[0], views[1], kv_len, softcap=softcap,
                              window=window)


def decode_split_partials_ref(q, k, v, kv_len, split_rows: int,
                              softcap: float = 0.0):
    """The partials the split-KV decode kernels write, in f32.

    q (B, H, D); k/v (B, S, Kh, D) dense per-slot rows (a gathered pool);
    rows [s * split_rows, (s + 1) * split_rows) form split s, rows at or
    past ``kv_len`` are left out.  Returns, per split and query head,
    the max score ``m`` (B, H, n), the sum of exp(score - m) ``l`` and the
    unnormalised accumulator ``acc`` (B, H, n, D); an empty split has
    m = -inf, l = 0, acc = 0."""
    B, H, D = q.shape
    S, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    qs = q.float().reshape(B, Kh, G, D) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    live = pos[None, :] < kv_len.to(q.device).long()[:, None]
    ms, ls, accs = [], [], []
    for r0 in range(0, S, split_rows):
        ks, vs = k[:, r0:r0 + split_rows].float(), v[:, r0:r0 + split_rows].float()
        s = torch.einsum("bhgd,bkhd->bhgk", qs, ks)
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        ok = live[:, None, None, r0:r0 + split_rows]
        s = s.masked_fill(~ok, float("-inf"))
        m = torch.amax(s, dim=-1)
        p = torch.where(ok, torch.exp(s - torch.where(
            torch.isfinite(m), m, torch.zeros_like(m))[..., None]),
            torch.zeros_like(s))
        ms.append(m.reshape(B, H))
        ls.append(p.sum(-1).reshape(B, H))
        accs.append(torch.einsum("bhgk,bkhd->bhgd", p, vs).reshape(B, H, D))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, 2)


def merge_split_partials_ref(m, l, acc) -> torch.Tensor:
    """The merge pass: weights exp(m_s - M) over the splits (an empty
    split, m = -inf, weighs 0), then acc / l; (B, H, D) f32, zeros where
    every split is empty."""
    M = torch.amax(m, dim=-1, keepdim=True)
    w = torch.where(torch.isfinite(m), torch.exp(m - torch.where(
        torch.isfinite(M), M, torch.zeros_like(M))), torch.zeros_like(m))
    L = (w * l).sum(-1)
    return (w[..., None] * acc).sum(2) / torch.clamp(L, min=1e-30)[..., None]


def paged_decode_attention_split_ref(q, k_pages, v_pages, block_tables,
                                     kv_len, split_rows: int,
                                     softcap: float = 0.0, k_scales=None,
                                     v_scales=None, k_new=None, v_new=None):
    """The paged decode as the split-KV kernel computes it: the slot's
    rows (int8 pages dequantised, the new row in place of row
    ``len - 1``, as ``paged_decode_attention_int8_ref`` reads them) cut
    into ``split_rows``-row splits over the block table's width, each
    split's partials, then the merge.  Returns (out in q's dtype,
    (m, l, acc))."""
    if k_scales is not None:
        k_pages = dequantize_pages_ref(k_pages, k_scales)
        v_pages = dequantize_pages_ref(v_pages, v_scales)
    views = [gather_pages(p, block_tables).float()
             for p in (k_pages, v_pages)]
    S = views[0].shape[1]
    kv_len = torch.clamp(kv_len.long().to(q.device), max=S)
    if k_new is not None:
        last = kv_len - 1
        has = torch.nonzero(last >= 0)[:, 0]
        for g, new in zip(views, (k_new, v_new)):
            g[has, last[has]] = new[has].float()
    parts = decode_split_partials_ref(q, views[0], views[1], kv_len,
                                      split_rows, softcap=softcap)
    return merge_split_partials_ref(*parts).to(q.dtype), parts


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, seg_ids=None) -> torch.Tensor:
    """(B, S, H, D) GQA causal attention (packed via seg_ids); above
    ``FULL_ATTN_MAX_SEQ`` rows blockwise, as the reference's prefill."""
    attend = (L.full_attention if q.shape[1] <= L.FULL_ATTN_MAX_SEQ
              else L.blockwise_attention)
    return attend(q, k, v, causal=causal, window=window, softcap=softcap,
                  seg_q=seg_ids, seg_k=seg_ids)


def fused_sample_ref(x, w, top_k: int = 1, softcap: float = 0.0):
    """Materialise the (B, V) logits in f32, then top-k + logsumexp.

    Products accumulate in f32 from the working dtype's values, as the
    Pallas kernel does.  Ties keep the lowest index first (a stable sort),
    as ``lax.top_k`` and ``argmax`` do."""
    logits = x.float() @ w.float()
    if softcap > 0:
        logits = torch.tanh(logits / softcap) * softcap
    if top_k == 1:
        vals, idx = torch.max(logits, dim=-1, keepdim=True)
    else:
        vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :top_k], idx[:, :top_k]
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    return vals, idx.to(torch.int32), lse
