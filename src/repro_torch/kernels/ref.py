"""Plain PyTorch versions of the kernels (counterpart of
``repro/kernels/ref.py``).  The wrappers use them for CPU tensors, and
``chip_smoke.py`` holds each CUDA kernel against them on the card."""
from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.models import layers as L

# Tolerance of int8 KV pages, the port's own copy of the reference's
# documented bound: max abs error of the paged decode attention OUTPUT
# over int8 pages (per-page symmetric scale, amax / 127) against the fp
# decode over the same K/V.
KV_INT8_DECODE_ATOL = 0.05


def ragged_decode_attention_ref(q, k_cache, v_cache, kv_len,
                                softcap: float = 0.0, window: int = 0,
                                kv_start=None, return_lse: bool = False):
    """(B, H, D) x (B, S, Kh, D) x (B,) -> (B, H, D); rows
    ``[kv_start, kv_len)`` (``kv_start`` (B,) or None for 0).  With
    ``return_lse`` also each head's log-sum-exp (B, H) f32 over those
    rows' scores, -inf where a slot has none."""
    return L.decode_attention(q, k_cache, v_cache, kv_len, softcap=softcap,
                              window=window, kv_start=kv_start,
                              return_lse=return_lse)


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


class DecodePiece(NamedTuple):
    """The pages [lo, hi) of item (slot b, KV head kh) that CTA ``cta`` of
    the bf16 paged decode kernel takes; ``slot`` is its workspace slot
    (2 cta for the CTA's first piece, 2 cta + 1 for its last), unused
    where the piece is the ``whole`` item."""
    cta: int
    b: int
    kh: int
    lo: int
    hi: int
    slot: int
    whole: bool


def paged_decode_work_plan(kv_len, P: int, nb: int, Kh: int, ctas: int,
                           group: int = 1
                           ) -> Tuple[List[Tuple[int, int]],
                                      List[DecodePiece]]:
    """The plain twin of the bf16 paged decode kernel's plan
    (``csrc/paged_decode_hopper.cuh``).  A unit is one page of a group of
    ``group`` KV heads of one slot (the kernel's ``pd_group``): pages(b) =
    ceil(min(kv_len[b], nb P) / P), ordered by slot, then KV head group,
    then page.  Of the U units, CTA c of C = min(ctas, U) takes [c U // C,
    (c + 1) U // C).  Returns the shares ((u0, u1) per CTA) and the pieces,
    item by item (an item is a (slot, KV head group); one piece a KV head
    of the group), each item's pieces in CTA order."""
    lens = [max(0, min(int(n), nb * P)) for n in kv_len]
    return _work_plan([-(-n // P) for n in lens], Kh, ctas, group)


def _work_plan(units, Kh: int, ctas: int, group: int):
    """The shares and pieces of a decode plan over ``units[b]`` units of
    each of slot b's KV head groups (see ``paged_decode_work_plan``)."""
    groups = Kh // group
    U = groups * sum(units)
    ce = min(ctas, U)
    shares = [(c * U // ce, (c + 1) * U // ce) for c in range(ce)]
    pieces, item0 = [], 0
    for b, npg in enumerate(units):
        for kg in range(groups if npg else 0):
            cf = ((item0 + 1) * ce - 1) // U
            cl = ((item0 + npg) * ce - 1) // U
            for c in range(cf, cl + 1):
                u0, u1 = shares[c]
                for kh in range(kg * group, (kg + 1) * group):
                    pieces.append(DecodePiece(
                        c, b, kh, max(u0, item0) - item0,
                        min(u1, item0 + npg) - item0,
                        2 * c + (0 if u0 >= item0 else 1), cf == cl))
            item0 += npg
    return shares, pieces


def paged_decode_plan_ref(q, k_pages, v_pages, block_tables, kv_len,
                          ctas: int, group: int = 1, softcap: float = 0.0,
                          k_scales=None, v_scales=None, k_new=None,
                          v_new=None):
    """The paged decode as the bf16 kernel's plan cuts it, in f32: each
    piece's partials (max, sum, unnormalised accumulator) over its pages'
    rows (int8 pages dequantised; the item's last page brings the new row
    ``k_new``/``v_new`` in place of row len - 1), then each item's pieces
    merged in CTA order (``merge_split_partials_ref``).  Returns (out in
    q's dtype, the pieces, their (m, l, acc) as (G,), (G,), (G, D))."""
    B, H, D = q.shape
    N, P, Kh, _ = k_pages.shape
    nb = block_tables.shape[1]
    G = H // Kh
    if k_scales is not None:
        k_pages = dequantize_pages_ref(k_pages, k_scales)
        v_pages = dequantize_pages_ref(v_pages, v_scales)
    kf, vf = k_pages.float(), v_pages.float()
    lens = [max(0, min(int(n), nb * P)) for n in kv_len.tolist()]
    _, pieces = paged_decode_work_plan(lens, P, nb, Kh, ctas, group)
    out = torch.zeros((B, H, D), dtype=torch.float32)
    parts, by_item = [], {}
    for pc in pieces:
        n, npg = lens[pc.b], -(-lens[pc.b] // P)
        new = k_new is not None and pc.hi == npg
        rows = range(pc.lo * P, min(pc.hi * P, n - (1 if new else 0)))
        pg = block_tables[pc.b].long()
        idx = torch.tensor(list(rows), dtype=torch.long)
        k = kf[pg[idx // P], idx % P, pc.kh]
        v = vf[pg[idx // P], idx % P, pc.kh]
        if new:
            k = torch.cat([k, k_new[pc.b, pc.kh][None].float()])
            v = torch.cat([v, v_new[pc.b, pc.kh][None].float()])
        qh = q[pc.b, pc.kh * G:(pc.kh + 1) * G].float()
        parts.append(_piece_partial(qh, k, v, softcap))
        by_item.setdefault((pc.b, pc.kh), []).append(parts[-1])
    _merge_items(out, by_item, G)
    return out.to(q.dtype), pieces, parts


def _piece_partial(qh, k, v, softcap: float):
    """f32 (max, sum, unnormalised accumulator) of the G heads ``qh``
    (G, D) over the rows ``k``/``v`` (n, D)."""
    s = qh @ k.T / math.sqrt(qh.shape[-1])
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    m = s.amax(-1)
    p = torch.exp(s - m[:, None])
    return m, p.sum(-1), p @ v


def _merge_items(out, by_item, G: int) -> None:
    """Each (slot, KV head)'s piece partials merged in CTA order into
    ``out`` (B, H, D)."""
    for (b, kh), ps in by_item.items():
        m, l, acc = zip(*ps)
        out[b, kh * G:(kh + 1) * G] = merge_split_partials_ref(
            torch.stack(m, -1)[None], torch.stack(l, -1)[None],
            torch.stack(acc, 1)[None])[0]


def _live_rows(kv_len, kv_start, S: int):
    """Each slot's first live row and live rows: [kv_start, min(kv_len,
    S)), none where kv_start >= min(kv_len, S)."""
    starts = ([0] * len(kv_len) if kv_start is None
              else [max(0, int(s)) for s in kv_start])
    return starts, [max(0, min(int(n), S) - s0)
                    for n, s0 in zip(kv_len, starts)]


def ragged_decode_work_plan(kv_len, kv_start, S: int, Kh: int, ctas: int,
                            rows: int = 16, group: int = 1
                            ) -> Tuple[List[Tuple[int, int]],
                                       List[DecodePiece]]:
    """The plain twin of the bf16 dense decode kernel's plan
    (``csrc/dense_decode_hopper.cuh``).  Slot b's live rows are
    [kv_start[b], min(kv_len[b], S)) (``kv_start`` None: from row 0); a
    unit is one chunk of ``rows`` of them (the kernel's ``dd_rows``) of a
    group of ``group`` KV heads (its ``pd_group``): chunks(b) =
    ceil(live(b) / rows), ordered by slot, then KV head group, then
    chunk.  Of the U units, CTA c of C = min(ctas, U) takes [c U // C,
    (c + 1) U // C).  Returns the shares ((u0, u1) per CTA) and the
    pieces, item by item, each item's pieces in CTA order; a piece's
    ``lo``/``hi`` count chunks of its slot's live rows."""
    _, lens = _live_rows(kv_len, kv_start, S)
    return _work_plan([-(-n // rows) for n in lens], Kh, ctas, group)


def ragged_decode_plan_ref(q, k_cache, v_cache, kv_len, ctas: int,
                           rows: int = 16, group: int = 1,
                           softcap: float = 0.0, kv_start=None):
    """The dense decode as the bf16 kernel's plan cuts it, in f32: each
    piece's partials (max, sum, unnormalised accumulator) over its chunks'
    live rows, then each item's pieces merged in CTA order
    (``merge_split_partials_ref``); slots with no live row give zeros.
    Returns (out in q's dtype, the pieces, their (m, l, acc) as (G,),
    (G,), (G, D))."""
    B, H, D = q.shape
    S, Kh = k_cache.shape[1], k_cache.shape[2]
    G = H // Kh
    starts, lens = _live_rows(kv_len.tolist(), None if kv_start is None
                              else kv_start.tolist(), S)
    _, pieces = ragged_decode_work_plan(kv_len.tolist(), starts, S, Kh,
                                        ctas, rows, group)
    out = torch.zeros((B, H, D), dtype=torch.float32)
    parts, by_item = [], {}
    for pc in pieces:
        r0 = starts[pc.b] + pc.lo * rows
        r1 = starts[pc.b] + min(pc.hi * rows, lens[pc.b])
        k = k_cache[pc.b, r0:r1, pc.kh].float()
        v = v_cache[pc.b, r0:r1, pc.kh].float()
        qh = q[pc.b, pc.kh * G:(pc.kh + 1) * G].float()
        parts.append(_piece_partial(qh, k, v, softcap))
        by_item.setdefault((pc.b, pc.kh), []).append(parts[-1])
    _merge_items(out, by_item, G)
    return out.to(q.dtype), pieces, parts


def flash_attention_ref(q, k, v, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, seg_ids=None) -> torch.Tensor:
    """(B, S, H, D) GQA causal attention (packed via seg_ids); above
    ``FULL_ATTN_MAX_SEQ`` rows blockwise, as the reference's prefill."""
    attend = (L.full_attention if q.shape[1] <= L.FULL_ATTN_MAX_SEQ
              else L.blockwise_attention)
    return attend(q, k, v, causal=causal, window=window, softcap=softcap,
                  seg_q=seg_ids, seg_k=seg_ids)


def flash_attention_rows_ref(q, k, v, window: int = 0, softcap: float = 0.0,
                             seg_ids=None, rows: int = 512) -> torch.Tensor:
    """Causal GQA attention in ``full_attention``'s arithmetic at any
    length: f32 scores of the unscaled q divided by sqrt(D), one f32
    softmax a row, f32 products with v, evaluated ``rows`` queries at a
    time against the keys they can see (so no score tensor exceeds
    (B, H, rows, S)).  What ``chip_smoke.py`` holds the flash kernel to:
    above ``FULL_ATTN_MAX_SEQ``, ``flash_attention_ref`` attends
    blockwise and rounds q/sqrt(D) to q's dtype, as the reference's long
    path does, where the kernel keeps that product in f32."""
    B, S, H, D = q.shape
    Kh = k.shape[2]
    G = H // Kh
    out = torch.empty_like(q)
    for q0 in range(0, S, rows):
        q1 = min(S, q0 + rows)
        k0 = max(0, q0 - window + 1) if window else 0
        qf = q[:, q0:q1].float().reshape(B, q1 - q0, Kh, G, D)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf,
                         k[:, k0:q1].float()) / math.sqrt(D)
        s = L._softcap(s, softcap)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None, :]
        mask = qpos >= kpos
        if window:
            mask = mask & (qpos - kpos < window)
        mask = mask.expand(B, q1 - q0, q1 - k0)
        if seg_ids is not None:
            mask = mask & (seg_ids[:, q0:q1, None] == seg_ids[:, None, k0:q1])
        s = s.masked_fill(~mask[:, None, None], float("-inf"))
        p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, v[:, k0:q1].float())
        out[:, q0:q1] = o.reshape(B, q1 - q0, H, D).to(q.dtype)
    return out


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
