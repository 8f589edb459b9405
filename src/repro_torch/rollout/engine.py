"""Slot-based rollout engine (counterpart of ``repro/rollout/engine.py``).

A fixed slot count decodes one token per active slot per ``step()``.
Two memory models, as in the reference:

* **paged** (the default): physical KV storage is a pool of fixed-size
  pages ``(L, num_pages, page_size, Kh, D)`` and each sequence owns a
  refcounted page table (:mod:`repro_torch.core.kv_cache`), which buys
  GRPO prefix sharing (a group's shared prompt prefills once) and resume
  without re-prefill (interrupted sequences keep their pages resident).
  With ``kv_quant="int8"`` the pool holds int8 pages and one f32 scale
  per (layer, page), 2x the tokens of a bf16 pool at equal bytes.
* **dense** (``paged=False``): one ``(L, capacity, max_total_len, Kh, D)``
  cache, the pre-paging layout, kept as the oracle of the paged token
  stream and the escape hatch of caches that cannot be paged.  No
  sharing, no resident KV, no migration; ``cache_stats()`` is None.

Where the reference gathers a dense per-slot view, decodes it and
scatters the written page back, this engine's decode step writes the new
token's K/V into its page in place and attends over the pool with the
paged decode kernel (``kernels/paged_decode_attention``, fp or int8
pages); the dense layout decodes with ``kernels/ragged_decode_attention``.
Prefill runs the flash kernel (``kernels/flash_attention``); greedy
decode with ``fused_sampling`` runs the fused head
(``kernels/fused_sample``).  On CPU tensors the same code runs the
kernels' plain versions.  Cache updates (prefill scatter, copy-on-write,
decode writes, imports) are in place.  The entry points that compute
(``submit``, ``step``, ``export_entry``, ``import_entry``) run under
``torch.no_grad()``: no autograd graph grows across decode steps, even
when the parameters behind ``params_fn`` require grad.

``step()`` stays loop-free on the host for slot bookkeeping: EOS/budget
masking, events and retirement are numpy array ops over the SlotTable.
Prefill widths are bucketed as in the reference (powers of two, clamped
to ``max_total_len``) so both engines see the same shapes.

Dense prefill runs at the bucketed width and copies those columns into
the slots; the reference prefills a ``max_total_len``-row sub-cache.
Rows at or past a slot's ``kv_len`` are never read, and decode writes row
``kv_len`` before reading it, so the token streams are the same.

Not ported yet, and refused with ``NotImplementedError``: families other
than dense, and windowed configs on CUDA (the decode kernels take no
window).  As in the reference, ``kv_quant``, ``packed_prefill`` and
``fused_sampling`` need the paged layout (``ValueError`` otherwise).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.engine_api import SlotTable, StepEvent
from repro_torch.core.kv_cache import PagedKVCache, PoolExhausted
from repro_torch.kernels import ops
from repro_torch.models import transformer as TF
from repro_torch.models.model import Model, supports_paging

DEFAULT_PAGE_SIZE = 16


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


class SlotEngine:
    def __init__(self, model: Model, params_fn: Callable[[], Dict],
                 capacity: int, max_total_len: int, max_gen_len: int,
                 eos_id: int, pad_id: int = 0, temperature: float = 1.0,
                 seed: int = 0, paged: Optional[bool] = None,
                 page_size: int = DEFAULT_PAGE_SIZE,
                 num_pages: Optional[int] = None,
                 kv_retain_across_sync: bool = True,
                 packed_prefill: bool = False,
                 fused_sampling: bool = False,
                 kv_quant: Optional[str] = None):
        cfg = model.cfg
        self.device = model.device
        if self.device.type == "cuda" and cfg.attn.sliding_window:
            raise NotImplementedError(
                "windowed configs: the CUDA decode kernels take no sliding "
                "window yet")
        if paged is None:
            paged = supports_paging(model)
        elif paged and not supports_paging(model):
            raise ValueError("paged KV cache requires right padding and a "
                             "{k, v} cache")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"kv_quant must be None or 'int8', got "
                             f"{kv_quant!r}")
        for flag, on in (("kv_quant", kv_quant), ("packed_prefill",
                                                  packed_prefill),
                         ("fused_sampling", fused_sampling)):
            if on and not paged:
                raise ValueError(f"{flag} requires the paged layout")
        self.paged = paged
        self.kv_quant = kv_quant
        self.model = model
        self.params_fn = params_fn
        self.capacity = capacity
        self.max_total_len = max_total_len
        self.max_gen_len = max_gen_len
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.temperature = temperature
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._t0 = time.monotonic()
        self.version = 0
        self.packed_prefill = packed_prefill
        self.fused_sampling = fused_sampling
        self.prefill_launches = 0       # one per prefill launch
        self.slots = SlotTable(capacity)
        self.kv_scales: Dict[str, torch.Tensor] = {}
        if not paged:
            self.cache = model.init_cache(capacity, max_total_len)
            self.kv = None
            return
        self.page_size = page_size
        self._pages_per_seq = -(-max_total_len // page_size)
        # default: dense-equivalent capacity + COW headroom + garbage page
        self.num_pages = num_pages or (
            capacity * self._pages_per_seq + capacity + 1)
        if kv_quant == "int8":
            # int8 pages + one f32 scale per (layer, page): 2x (bf16) / 4x
            # (f32) the tokens at equal bytes
            self.cache = TF.init_cache(cfg, self.num_pages, page_size,
                                       self.device, dtype=torch.int8)
            self.kv_scales = {n: torch.ones((cfg.num_layers, self.num_pages),
                                            dtype=torch.float32,
                                            device=self.device)
                              for n in ("k", "v")}
        else:
            self.cache = model.init_cache(self.num_pages, page_size)
        self.kv = PagedKVCache(self.num_pages, page_size,
                               retain_across_sync=kv_retain_across_sync)

    # -- time / slot queries ------------------------------------------------

    @property
    def clock(self) -> float:
        return time.monotonic() - self._t0

    def free_slots(self) -> int:
        return self.slots.free_count()

    def active_uids(self) -> List[int]:
        return self.slots.active_uids()

    def sync_weights(self, version: int) -> None:
        if self.paged:
            self.kv.sync_version(version)
        self.version = version   # params_fn always reads the latest state

    def cache_stats(self) -> Optional[Dict[str, float]]:
        """Page-pool gauges + prefix-sharing counters (None when dense)."""
        if not self.paged:
            return None
        d = self.kv.stats_dict()
        d["prefill_launches"] = float(self.prefill_launches)
        return d

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(arr), device=self.device)

    # -- submit: prefill of unique prefixes into pages ----------------------

    @torch.no_grad()
    def submit(self, entries, version: int) -> None:
        if not entries:
            return
        slots = self.slots.allocate(len(entries))
        seqs = [list(e.prompt) + list(e.generated) for e in entries]
        # prefill everything but the last token; it is fed on the next step
        pre = [s[:-1] for s in seqs]
        if self.paged:
            self._submit_paged(entries, slots, seqs, pre)
        else:
            self._submit_dense(entries, slots, seqs, pre)

    def _submit_dense(self, entries, slots, seqs, pre) -> None:
        """One bucketed prefill of every prefix at ``width`` columns,
        copied into the slots' rows ``[0, width)``."""
        k = len(entries)
        params = self.params_fn()
        width = self._bucket_width(max(1, max(len(p) for p in pre)))
        kb = self._bucket_batch(k)
        toks = np.full((kb, width), self.pad_id, np.int32)
        plens = np.zeros(kb, np.int32)
        for i, p in enumerate(pre):
            plens[i] = len(p)
            toks[i, :len(p)] = p                # right padding
        batch = {"tokens": self._tensor(toks),
                 "prompt_lens": self._tensor(plens)}
        sub_cache = self.model.init_cache(kb, width)
        _, sub_cache = self.model.prefill(params, batch, sub_cache,
                                          return_logits=False)
        self.prefill_launches += 1
        idx = self._tensor(np.asarray(slots, np.int64))
        for name, arr in self.cache.items():
            arr[:, idx, :width] = sub_cache[name][:, :k].to(arr.dtype)

        t = self.slots
        t.uid[slots] = [e.uid for e in entries]
        t.active[slots] = True
        t.next_token[slots] = [s[-1] for s in seqs]
        t.kv_len[slots] = plens[:k]
        t.kv_start[slots] = 0
        t.gen_count[slots] = [len(e.generated) for e in entries]
        t.gen_budget[slots] = self.max_gen_len

    def _submit_paged(self, entries, slots, seqs, pre) -> None:
        """Prefill only unique, non-resident prefixes; map everyone else
        onto existing pages (prefix sharing / resume-without-reprefill)."""
        kv = self.kv
        leaders: List[int] = []
        followers: List[Tuple[int, int]] = []   # (idx, leader idx)
        key_leader: Dict[Tuple[int, ...], int] = {}
        for i, e in enumerate(entries):
            key = tuple(pre[i])
            if kv.try_resume(e.uid, key):
                continue                        # pages still resident
            donor = kv.find_donor(key)
            if donor is not None:
                kv.share(e.uid, donor, key)     # cross-batch sharing
                continue
            li = key_leader.get(key)
            if li is None:
                key_leader[key] = i
                leaders.append(i)
            else:
                followers.append((i, li))       # in-batch sharing
        if leaders:
            self._prefill_to_pages([entries[i] for i in leaders],
                                   [pre[i] for i in leaders])
        for i, li in followers:
            kv.share(entries[i].uid, entries[li].uid, tuple(pre[i]))

        t = self.slots
        t.uid[slots] = [e.uid for e in entries]
        t.active[slots] = True
        t.next_token[slots] = [s[-1] for s in seqs]
        t.kv_len[slots] = [len(p) for p in pre]
        t.kv_start[slots] = 0
        t.gen_count[slots] = [len(e.generated) for e in entries]
        t.gen_budget[slots] = self.max_gen_len

    def _prefill_to_pages(self, entries, pres) -> None:
        """One bucketed prefill launch over the unique prefixes, scattered
        into fresh pages (packed into rows with ``packed_prefill``)."""
        if self.packed_prefill:
            self._prefill_to_pages_packed(entries, pres)
            return
        params = self.params_fn()
        P = self.page_size
        width = self._bucket_width(max(1, max(len(p) for p in pres)))
        kb = self._bucket_batch(len(entries))
        cache_len = -(-width // P) * P
        toks = np.full((kb, width), self.pad_id, np.int32)
        plens = np.zeros(kb, np.int32)
        for i, p in enumerate(pres):
            plens[i] = len(p)
            toks[i, :len(p)] = p                # paged => right padding
        batch = {"tokens": self._tensor(toks),
                 "prompt_lens": self._tensor(plens)}
        sub_cache = self.model.init_cache(kb, cache_len)
        _, sub_cache = self.model.prefill(params, batch, sub_cache,
                                          return_logits=False)
        self.prefill_launches += 1

        rows, blks, phys = [], [], []
        for i, (e, p) in enumerate(zip(entries, pres)):
            table = self.kv.register_prefill(e.uid, tuple(p))
            for j, page in enumerate(table):
                rows.append(i)
                blks.append(j)
                phys.append(page)
        self._scatter_pages(sub_cache, rows, blks, phys)

    def _prefill_to_pages_packed(self, entries, pres) -> None:
        """Packed ragged prefill: first-fit-decreasing packing of
        page-aligned prefix spans into ``max_total_len``-column rows, one
        segment-masked launch for the whole wave; positions restart per
        segment, so each prefix's KV equals a solo prefill's."""
        params = self.params_fn()
        P = self.page_size
        span = [-(-max(len(p), 1) // P) * P for p in pres]
        order = sorted(range(len(pres)), key=lambda i: -span[i])
        row_of = [0] * len(pres)
        offset = [0] * len(pres)
        fill: List[int] = []                    # columns used per row
        for i in order:
            for r, used in enumerate(fill):
                if used + span[i] <= self.max_total_len:
                    row_of[i], offset[i] = r, used
                    fill[r] = used + span[i]
                    break
            else:
                row_of[i], offset[i] = len(fill), 0
                fill.append(span[i])
        width = self._bucket_width(max(fill))
        kb = self._bucket_batch(len(fill))
        cache_len = -(-width // P) * P

        toks = np.full((kb, width), self.pad_id, np.int32)
        seg = np.full((kb, width), -1, np.int32)
        pos = np.zeros((kb, width), np.int32)
        plens = np.zeros(kb, np.int32)
        for i, p in enumerate(pres):
            r, o = row_of[i], offset[i]
            toks[r, o:o + len(p)] = p
            seg[r, o:o + span[i]] = i           # pad tail shares the segment
            pos[r, o:o + span[i]] = np.arange(span[i])
            plens[r] = max(plens[r], o + len(p))
        batch = {"tokens": self._tensor(toks),
                 "prompt_lens": self._tensor(plens),
                 "seg_ids": self._tensor(seg),
                 "positions": self._tensor(pos)}
        sub_cache = self.model.init_cache(kb, cache_len)
        _, sub_cache = self.model.prefill_packed(params, batch, sub_cache,
                                                 return_logits=False)
        self.prefill_launches += 1

        rows, blks, phys = [], [], []
        for i, (e, p) in enumerate(zip(entries, pres)):
            table = self.kv.register_prefill(e.uid, tuple(p))
            for j, page in enumerate(table):
                rows.append(row_of[i])
                blks.append(offset[i] // P + j)
                phys.append(page)
        self._scatter_pages(sub_cache, rows, blks, phys)

    def _scatter_pages(self, sub_cache, rows, blks, phys) -> None:
        """Copy prefilled KV page blocks into the pool at ``phys``,
        quantising each (layer, page) to int8 with scale amax / 127 (1e-8
        floor) on an int8 pool, as the reference does."""
        P = self.page_size
        rows, blks, phys = (self._tensor(np.asarray(a, np.int64))
                            for a in (rows, blks, phys))
        for name in ("k", "v"):
            sub = sub_cache[name]               # (L, kb, cache_len, Kh, D)
            nl, nb_, ns = sub.shape[:3]
            blocks = sub.reshape(nl, nb_, ns // P, P, *sub.shape[3:])
            sel = blocks[:, rows, blks]         # (L, n_pages, P, Kh, D)
            pool = self.cache[name]
            if self.kv_quant == "int8":
                sel = sel.float()
                s = torch.clamp(sel.abs().amax(dim=(2, 3, 4)),
                                min=1e-8) / 127.0
                pool[:, phys] = torch.clamp(
                    torch.round(sel / s[:, :, None, None, None]),
                    -127, 127).to(torch.int8)
                self.kv_scales[name][:, phys] = s
            else:
                pool[:, phys] = sel.to(pool.dtype)

    def _bucket_width(self, width: int) -> int:
        assert width <= self.max_total_len, (width, self.max_total_len)
        # padded positions beyond prompt_lens are masked via kv_len
        return min(next_pow2(width), self.max_total_len)

    def _bucket_batch(self, k: int) -> int:
        return min(next_pow2(k), self.capacity)

    # -- decode ---------------------------------------------------------------

    def _sample(self, logits: torch.Tensor):
        logits = logits.float()
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        else:
            sampled = torch.argmax(logits, dim=-1)   # first index on ties
        logprobs = torch.log_softmax(logits, dim=-1)
        lp = torch.gather(logprobs, 1, sampled[:, None])[:, 0]
        return sampled.to(torch.int32), lp

    def _fused_greedy(self, params, hidden: torch.Tensor):
        """Greedy token and its logprob from the fused head kernel: top-1
        (lowest index on ties, as argmax) and the logsumexp, with no (B, V)
        logits.  A tied head passes ``embed.T`` as a strided view."""
        cfg = self.model.cfg
        vals, idx, lse = ops.fused_sample(
            hidden.contiguous(), TF.head_weight(params, cfg), top_k=1,
            softcap=cfg.logit_softcap)
        return idx[:, 0], vals[:, 0] - lse[:, 0]

    def _copy_pages(self, copies: List[Tuple[int, int]]) -> None:
        """Host-planned copy-on-write page copies, on the device (scale
        planes travel with their pages on an int8 pool)."""
        src = self._tensor(np.asarray([s for s, _ in copies], np.int64))
        dst = self._tensor(np.asarray([d for _, d in copies], np.int64))
        for arr in (*self.cache.values(), *self.kv_scales.values()):
            arr[:, dst] = arr[:, src]

    def _decode(self, params, token, kv_len):
        """One decode step over the dense cache or the page pool: returns
        the sampled tokens (B,) and their logprobs (B,) on the device."""
        fused = self.fused_sampling and self.temperature == 0
        if self.paged:
            t = self.slots
            act = t.active_indices()
            uids_act = t.uid[act].tolist()
            copies = self.kv.prepare_step(uids_act, t.kv_len[act].tolist())
            if copies:
                self._copy_pages(copies)
            nb = min(next_pow2(max(1, self.kv.max_blocks(uids_act))),
                     self._pages_per_seq)
            bt = self._tensor(self.kv.block_table(t.uid.tolist(), nb))
            out, _ = self.model.decode_step_paged(
                params, token, self.cache, bt, kv_len, return_hidden=fused,
                scales=self.kv_scales or None)
            self.kv.append_tokens(uids_act, t.next_token[act].tolist())
        else:
            out, _ = self.model.decode_step(params, token, self.cache,
                                            kv_len)
        return self._fused_greedy(params, out) if fused else \
            self._sample(out)

    @torch.no_grad()
    def step(self) -> List[StepEvent]:
        t = self.slots
        act = t.active_indices()
        if act.size == 0:
            return []
        params = self.params_fn()
        kv_len = np.where(t.active, t.kv_len, 0).astype(np.int32)
        sampled, lp = self._decode(params, self._tensor(t.next_token),
                                   self._tensor(kv_len))
        sampled = sampled.cpu().numpy()
        lp = lp.float().cpu().numpy()

        # vectorized bookkeeping over the active slots (ascending order)
        t.kv_len[act] += 1
        t.gen_count[act] += 1
        toks = sampled[act]
        eos = toks == self.eos_id
        over = ((t.gen_count[act] >= t.gen_budget[act])
                | (t.kv_len[act] >= self.max_total_len - 1))
        done = eos | over
        reasons = np.where(eos, "eos", np.where(over, "length", None))

        uids = t.uid[act].tolist()          # read before batched release
        if self.paged:
            self.kv.release_many(t.uid[act[done]].tolist())
        t.release(act[done])
        cont = act[~done]
        t.next_token[cont] = toks[~done]

        return [StepEvent(uid=u, token=tk, logprob=l, done=d, finish_reason=r)
                for u, tk, l, d, r in zip(uids, toks.tolist(), lp[act].tolist(),
                                          done.tolist(), reasons.tolist())]

    def interrupt(self, uids: Optional[Sequence[int]] = None) -> List[int]:
        sel = self.slots.select(uids)
        out = [int(u) for u in self.slots.uid[sel]]
        self.slots.release(sel)
        if self.paged:
            self.kv.deactivate_many(out)   # keep pages resident for resume
        return out

    def shutdown(self) -> None:
        """Fence the engine: release every slot and purge the page pool.
        Counters survive."""
        self.slots.release(self.slots.active_indices())
        if self.paged:
            self.kv.purge()

    # -- migration capability (export -> import -> discard) ----------------
    #
    # The handle layout is the reference's (``engine.py`` export_entry):
    # page-table bookkeeping plus the physical KV rows as numpy arrays
    # (L, n_pages, P, Kh, D), and on an int8 pool the (L, n_pages) scales,
    # so a handle exported by the reference engine imports here and
    # continues token-identically.  bf16 rows travel as f32 arrays
    # (exact), int8 rows as int8.  The dense layout migrates nothing.

    @torch.no_grad()
    def export_entry(self, uid: int) -> Optional[Dict]:
        if not self.paged or uid not in self.kv.tables:
            return None
        ex = self.kv.export_pages(uid)
        pages = self._tensor(np.asarray(ex.pages, np.int64))

        def rows(arr):
            r = arr[:, pages].cpu()
            return (r.float() if r.dtype == torch.bfloat16 else r).numpy()

        handle = {"engine": "slot", "uid": uid, "active": ex.active,
                  "kv": ex, "kv_quant": self.kv_quant,
                  "pages_k": rows(self.cache["k"]),
                  "pages_v": rows(self.cache["v"])}
        if self.kv_quant:
            handle["scales_k"] = rows(self.kv_scales["k"])
            handle["scales_v"] = rows(self.kv_scales["v"])
        if ex.active:
            sel = np.flatnonzero((self.slots.uid == uid) & self.slots.active)
            assert sel.size == 1, (uid, sel)
            i = int(sel[0])
            t = self.slots
            handle["slot"] = {"next_token": int(t.next_token[i]),
                              "kv_len": int(t.kv_len[i]),
                              "kv_start": int(t.kv_start[i]),
                              "gen_count": int(t.gen_count[i]),
                              "gen_budget": int(t.gen_budget[i])}
        return handle

    @torch.no_grad()
    def import_entry(self, handle: Dict) -> bool:
        """Land a migrated entry with its KV; False (engine unchanged) when
        it cannot accept: dense layout, pages of the other kind (int8 and
        fp pools do not mix page bytes), stale KV under strict sync, no
        free slot, or an exhausted pool."""
        if handle.get("engine") != "slot" or not self.paged:
            return False
        if handle.get("kv_quant") != self.kv_quant:
            return False
        ex = handle["kv"]
        if not self.kv.retain_across_sync and ex.version != self.kv.version:
            return False
        if ex.active and self.free_slots() <= 0:
            return False
        try:
            pages = self.kv.import_pages(ex)
        except PoolExhausted:
            return False
        idx = self._tensor(np.asarray(pages, np.int64))
        rows_dtype = np.int8 if self.kv_quant else np.float32
        for name in ("k", "v"):
            rows = np.asarray(handle[f"pages_{name}"], rows_dtype)
            pool = self.cache[name]
            pool[:, idx] = self._tensor(rows).to(pool.dtype)
            if self.kv_quant:
                self.kv_scales[name][:, idx] = self._tensor(
                    np.asarray(handle[f"scales_{name}"], np.float32))
        if ex.active:
            s = handle["slot"]
            slot = self.slots.allocate(1)
            t = self.slots
            t.uid[slot] = ex.uid
            t.active[slot] = True
            t.next_token[slot] = s["next_token"]
            t.kv_len[slot] = s["kv_len"]
            t.kv_start[slot] = s["kv_start"]
            t.gen_count[slot] = s["gen_count"]
            t.gen_budget[slot] = s["gen_budget"]
        return True

    def discard_entry(self, uid: int) -> None:
        """Drop every local trace of a migrated-away uid (slot + pages)."""
        sel = self.slots.select([uid])
        if sel.size:
            self.slots.release(sel)
        if self.paged:
            self.kv.release_seq(uid)
