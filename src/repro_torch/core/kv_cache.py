"""Paged KV-cache bookkeeping: block pool, page tables, prefix sharing.

The paper's cache mechanism made concrete.  Physical KV storage is a pool
of fixed-size pages; each sequence owns an ordered *page table* (logical
block -> physical page).  Pages are refcounted so that

  * a GRPO group prefills its shared prompt ONCE — every member's table
    maps the same prefix pages (Seer-style context sharing);
  * divergence is handled by copy-on-write: before a slot writes into a
    page whose refcount > 1, it gets a private copy;
  * interrupted sequences keep their pages *resident* (APRIL-style active
    partial rollouts), so resuming after early termination skips
    re-prefill entirely — in partial mode the whole prefix, in on-policy
    mode the prompt prefix survives the re-roll.

This module is pure host-side bookkeeping (numpy + python), a verbatim
copy of the reference package's ``core/kv_cache.py`` so that the port
imports nothing of it; device page arrays live in the engine
(``repro_torch.rollout.engine``) and the attention over them in
``repro_torch.kernels.paged_decode_attention``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

TokenKey = Tuple[int, ...]

# physical page 0 is reserved as the garbage page: inactive decode slots
# read from and write to it, so real pages are never corrupted by the
# fixed-shape decode step.
GARBAGE_PAGE = 0


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable — the pool is oversubscribed."""


class PagePool:
    """Refcounted pool of fixed-size KV pages (physical allocation only)."""

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2 and page_size >= 1
        self.num_pages = num_pages
        self.page_size = page_size
        self.refcount = np.zeros(num_pages, np.int64)
        # page 0 reserved (garbage); free list as a LIFO stack
        self._free: List[int] = list(range(num_pages - 1, 0, -1))

    # -- queries ----------------------------------------------------------

    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def occupancy(self) -> float:
        return self.pages_in_use / (self.num_pages - 1)

    # -- alloc / refcounting ---------------------------------------------

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"page pool exhausted ({self.num_pages - 1} pages of "
                f"{self.page_size} rows)")
        page = self._free.pop()
        assert self.refcount[page] == 0, page
        self.refcount[page] = 1
        return page

    def retain(self, page: int) -> int:
        assert page != GARBAGE_PAGE and self.refcount[page] > 0, page
        self.refcount[page] += 1
        return page

    def release(self, page: int) -> bool:
        """Drop one reference; returns True when the page was freed."""
        assert page != GARBAGE_PAGE and self.refcount[page] > 0, page
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)
            return True
        return False


@dataclasses.dataclass
class CacheStats:
    """Cumulative counters + point-in-time pool gauges."""
    prefill_tokens_run: int = 0       # tokens actually pushed through prefill
    prefill_tokens_saved: int = 0     # tokens skipped via sharing / residency
    shared_prefills: int = 0          # sequences that mapped existing pages
    resumed_without_prefill: int = 0  # scavenged sequences resumed in place
    cow_copies: int = 0               # copy-on-write page copies
    evictions: int = 0                # resident sequences evicted for space
    stale_kv_reuses: int = 0          # resumes/shares of pre-sync KV (see
                                      # retain_across_sync)
    migrated_pages: int = 0           # pages imported from another pool
                                      # (cross-replica KV migration)
    resume_attempts: int = 0          # resubmits of previously interrupted
                                      # uids (hit -> resumed_without_prefill;
                                      # miss -> the entry was evicted or
                                      # invalidated and must re-prefill)

    def as_dict(self, pool: PagePool, resident: int) -> Dict[str, float]:
        return {
            "prefill_tokens_run": self.prefill_tokens_run,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "shared_prefills": self.shared_prefills,
            "resumed_without_prefill": self.resumed_without_prefill,
            "cow_copies": self.cow_copies,
            "evictions": self.evictions,
            "stale_kv_reuses": self.stale_kv_reuses,
            "migrated_pages": self.migrated_pages,
            "resume_attempts": self.resume_attempts,
            # the zero-re-prefill hit rate under memory pressure — THE
            # gauge int8 KV pages exist to raise (more resident entries
            # per byte survive eviction on an oversubscribed pool)
            "resident_resume_rate": (self.resumed_without_prefill
                                     / max(self.resume_attempts, 1)),
            "pages_in_use": pool.pages_in_use,
            "pages_total": pool.num_pages - 1,
            "page_occupancy": pool.occupancy(),
            # token capacity of the pool (garbage page excluded) — for an
            # int8 pool this is ~2x (bf16) / ~4x (f32) the equal-byte fp
            # pool's figure
            "pool_capacity_tokens": (pool.num_pages - 1) * pool.page_size,
            "resident_seqs": resident,
        }


@dataclasses.dataclass
class PageExport:
    """Host-side record of one sequence's pages for cross-pool migration.

    Produced by :meth:`PagedKVCache.export_pages` WITHOUT mutating the
    donor: ``pages`` are donor-physical ids the engine must copy buffer
    contents from before the donor releases the sequence.  Consumed by
    :meth:`PagedKVCache.import_pages` on the destination pool, which
    allocates a fresh span and re-registers the sequence (active or
    resident) so a migrated entry resumes with zero re-prefill.
    """
    uid: int
    tokens: List[int]
    version: int          # policy version the KV was committed under
    pages: List[int]      # donor-physical page ids, logical order
    active: bool          # occupied an engine slot (vs resident-for-resume)
    donor_keys: List[TokenKey]    # prefix keys the uid served as donor for


class PagedKVCache:
    """Per-sequence page tables + prefix sharing over one :class:`PagePool`.

    Tracks, per uid: the physical page table (logical order), the token
    prefix whose KV is committed to those pages, and whether the sequence
    is *active* (occupies an engine slot) or *resident* (interrupted but
    kept warm for resume).  ``extra_rows`` models cache rows prepended by
    stub frontends (``Model.prefill_extra``): committed rows =
    len(tokens) + extra_rows.

    The engine calls, in order per step: :meth:`prepare_step` (COW +
    write-page allocation), decodes against :meth:`block_table` rows, then
    :meth:`append_tokens` for the fed tokens and :meth:`release_seq` for
    finished uids.

    **Weight sync.** Each sequence is stamped with the policy version its
    KV was committed under (:meth:`sync_version`).  With
    ``retain_across_sync=True`` (default) resident pages and donors
    survive weight updates — the PipelineRL/APRIL-style approximation:
    resumed continuations attend to pre-update KV while their recorded
    per-token log-probs stay exact, and each reuse is counted in
    ``stats.stale_kv_reuses``.  With ``retain_across_sync=False`` a
    version bump invalidates every pre-sync prefix (residents dropped,
    donors cleared, actives refused later resume), restoring the dense
    engine's fresh-prefill-after-update semantics — the right setting for
    on-policy re-rolls, where stale prompt KV would bias the new policy's
    rollouts.
    """

    def __init__(self, num_pages: int, page_size: int, extra_rows: int = 0,
                 retain_across_sync: bool = True):
        self.pool = PagePool(num_pages, page_size)
        self.page_size = page_size
        self.extra_rows = extra_rows
        self.retain_across_sync = retain_across_sync
        self.version = 0
        self.tables: Dict[int, List[int]] = {}
        self.tokens: Dict[int, List[int]] = {}
        self._seq_version: Dict[int, int] = {}
        self._active: Set[int] = set()
        self._resident: Dict[int, None] = {}          # insertion-ordered LRU
        # prefix donors: committed token key -> uids whose tables cover it
        self._donors: Dict[TokenKey, Set[int]] = {}
        self._donor_keys: Dict[int, Set[TokenKey]] = {}
        # uids interrupted at some point and not yet resubmitted — their
        # next submit is a *resume attempt* whether or not the pages
        # survived eviction (see CacheStats.resume_attempts)
        self._interrupted: Set[int] = set()
        self.stats = CacheStats()

    # -- helpers ----------------------------------------------------------

    def rows(self, uid: int) -> int:
        return len(self.tokens[uid]) + self.extra_rows

    def _pages_for_rows(self, rows: int) -> int:
        return max(1, -(-rows // self.page_size))

    def _alloc(self) -> int:
        while True:
            try:
                return self.pool.alloc()
            except PoolExhausted:
                if not self._evict_one():
                    raise

    def _evict_one(self) -> bool:
        for uid in self._resident:
            del self._resident[uid]
            self._drop(uid)
            self.stats.evictions += 1
            return True
        return False

    def _drop(self, uid: int) -> None:
        for page in self.tables.pop(uid):
            self.pool.release(page)
        del self.tokens[uid]
        self._seq_version.pop(uid, None)
        for key in self._donor_keys.pop(uid, ()):
            holders = self._donors.get(key)
            if holders is not None:
                holders.discard(uid)
                if not holders:
                    del self._donors[key]

    def _register_donor(self, uid: int, key: TokenKey) -> None:
        if not key:
            return
        self._donors.setdefault(key, set()).add(uid)
        self._donor_keys.setdefault(uid, set()).add(key)

    # -- weight sync ------------------------------------------------------

    def _stale(self, uid: int) -> bool:
        return self._seq_version.get(uid, self.version) != self.version

    def sync_version(self, version: int) -> None:
        """The engine synced weights.  Retaining mode keeps everything
        (reuses are counted); strict mode drops every resident prefix
        committed under an older version — actives keep decoding (in-
        flight version mixing is inherent to async RL) but are refused
        later resume/donor use by the stamp checks."""
        if version == self.version:
            return
        self.version = version
        if self.retain_across_sync:
            return
        for uid in [u for u in self._resident if self._stale(u)]:
            del self._resident[uid]
            self._drop(uid)

    # -- submit-time planning ---------------------------------------------

    def try_resume(self, uid: int, tokens: Sequence[int]) -> bool:
        """Resume a resident sequence without re-prefill.

        True when `uid` is resident and its committed prefix covers
        `tokens` (partial mode: exactly; on-policy re-roll: a prompt
        prefix of a longer resident sequence — trimmed down).  On False
        any stale residency for `uid` is dropped.
        """
        if uid in self._interrupted:
            # count the attempt even when the pages were already evicted
            # (uid absent from tables) — misses under memory pressure are
            # exactly what resident_resume_rate measures
            self._interrupted.discard(uid)
            self.stats.resume_attempts += 1
        if uid not in self.tables or uid in self._active:
            return False
        have = self.tokens[uid]
        n = len(tokens)
        if len(have) < n or have[:n] != list(tokens):
            self._resident.pop(uid, None)
            self._drop(uid)
            return False
        if self._stale(uid):
            if not self.retain_across_sync:
                self._resident.pop(uid, None)
                self._drop(uid)
                return False
            self.stats.stale_kv_reuses += 1
        self._trim(uid, n)
        self._resident.pop(uid, None)
        self._active.add(uid)
        self.stats.prefill_tokens_saved += n
        self.stats.resumed_without_prefill += 1
        return True

    def _trim(self, uid: int, n_tokens: int) -> None:
        keep = self._pages_for_rows(n_tokens + self.extra_rows)
        table = self.tables[uid]
        for page in table[keep:]:
            self.pool.release(page)
        del table[keep:]
        del self.tokens[uid][n_tokens:]

    def find_donor(self, key: TokenKey) -> Optional[int]:
        """A uid whose committed pages cover `key`, or None.  Strict-sync
        mode refuses donors whose KV predates the live version."""
        for uid in self._donors.get(key, ()):
            if self._stale(uid) and not self.retain_across_sync:
                continue
            have = self.tokens.get(uid)
            if have is not None and have[:len(key)] == list(key):
                return uid
        return None

    def share(self, uid: int, donor: int, key: TokenKey) -> None:
        """Map `uid` onto the donor's prefix pages (prefill skipped)."""
        assert uid not in self.tables, uid
        need = self._pages_for_rows(len(key) + self.extra_rows)
        src = self.tables[donor]
        assert len(src) >= need, (uid, donor, need, len(src))
        self.tables[uid] = [self.pool.retain(p) for p in src[:need]]
        self.tokens[uid] = list(key)
        self._seq_version[uid] = self._seq_version.get(donor, self.version)
        if self._stale(uid):
            self.stats.stale_kv_reuses += 1
        self._active.add(uid)
        self._register_donor(uid, key)
        self.stats.prefill_tokens_saved += len(key)
        self.stats.shared_prefills += 1

    def register_prefill(self, uid: int, key: TokenKey) -> List[int]:
        """Allocate fresh pages for a prefilled sequence; returns the
        physical page table (for the engine to copy KV rows into)."""
        assert uid not in self.tables, uid
        need = self._pages_for_rows(len(key) + self.extra_rows)
        pages: List[int] = []
        try:
            for _ in range(need):
                pages.append(self._alloc())
        except PoolExhausted:
            # roll back the partial allocation — a failed submit must not
            # leak pages (refcount > 0 with no owning table)
            for page in pages:
                self.pool.release(page)
            raise
        self.tables[uid] = pages
        self.tokens[uid] = list(key)
        self._seq_version[uid] = self.version
        self._active.add(uid)
        self._register_donor(uid, key)
        self.stats.prefill_tokens_run += len(key)
        return list(self.tables[uid])

    # -- cross-pool migration ---------------------------------------------

    def export_pages(self, uid: int) -> PageExport:
        """Snapshot `uid`'s span for migration to another pool.

        Pure read: the donor keeps its pages (and any sharers keep
        theirs) until the caller has copied the buffer contents and
        explicitly calls :meth:`release_seq`.  That ordering lets a
        failed import fall back without having destroyed the donor copy.
        """
        assert uid in self.tables, uid
        return PageExport(
            uid=uid, tokens=list(self.tokens[uid]),
            version=self._seq_version.get(uid, self.version),
            pages=list(self.tables[uid]),
            active=uid in self._active,
            donor_keys=sorted(self._donor_keys.get(uid, ())))

    def import_pages(self, export: PageExport) -> List[int]:
        """Land a migrated span in THIS pool: allocate len(export.pages)
        fresh pages (evicting residents under pressure, rolling back on
        exhaustion) and re-register the sequence — active if it occupied
        a slot on the donor, resident-for-resume otherwise.  Returns the
        new physical page table for the engine's buffer copy; counts the
        span in ``stats.migrated_pages``."""
        uid = export.uid
        assert uid not in self.tables, uid
        pages: List[int] = []
        try:
            for _ in range(len(export.pages)):
                pages.append(self._alloc())
        except PoolExhausted:
            # a failed import must not leak the partial span
            for page in pages:
                self.pool.release(page)
            raise
        self.tables[uid] = pages
        self.tokens[uid] = list(export.tokens)
        self._seq_version[uid] = export.version
        if export.active:
            self._active.add(uid)
        else:
            self._resident[uid] = None
            # a migrated resident entry's next submit here is a resume
            # attempt, same as on the donor pool
            self._interrupted.add(uid)
        # re-register the SOURCE pool's donor keys (typically the prefill
        # prefix), not the full committed sequence: a migrated GRPO member
        # must keep attracting its siblings' prompt key here
        for key in export.donor_keys:
            self._register_donor(uid, tuple(key))
        self.stats.migrated_pages += len(pages)
        return list(pages)

    # -- decode-time ------------------------------------------------------

    def prepare_step(self, uids: Sequence[int], positions: Sequence[int]
                     ) -> List[Tuple[int, int]]:
        """Make each uid's write page (covering `position`) exclusively
        owned, allocating/copying as needed.  Returns (src, dst) physical
        page pairs the engine must copy on device before decoding."""
        copies: List[Tuple[int, int]] = []
        for uid, pos in zip(uids, positions):
            table = self.tables[uid]
            blk = pos // self.page_size
            assert blk <= len(table), (uid, pos, len(table))
            if blk == len(table):
                table.append(self._alloc())
            elif self.pool.refcount[table[blk]] > 1:
                new = self._alloc()
                copies.append((table[blk], new))
                self.pool.release(table[blk])
                table[blk] = new
                self.stats.cow_copies += 1
        return copies

    def block_table(self, uids: Sequence[int], n_blocks: int) -> np.ndarray:
        """(len(uids), n_blocks) physical page ids, garbage-padded.  A uid
        of -1 (inactive slot) maps entirely to the garbage page."""
        out = np.full((len(uids), n_blocks), GARBAGE_PAGE, np.int32)
        for i, uid in enumerate(uids):
            if uid < 0:
                continue
            table = self.tables[uid]
            n = min(len(table), n_blocks)
            out[i, :n] = table[:n]
        return out

    def append_tokens(self, uids: Sequence[int], tokens: Sequence[int]
                      ) -> None:
        """Record the tokens fed this step (their KV is now committed)."""
        for uid, tok in zip(uids, tokens):
            self.tokens[uid].append(int(tok))

    # -- lifecycle --------------------------------------------------------

    def release_seq(self, uid: int) -> None:
        """Sequence finished: drop its pages entirely."""
        self._active.discard(uid)
        self._resident.pop(uid, None)
        self._interrupted.discard(uid)
        if uid in self.tables:
            self._drop(uid)

    def release_many(self, uids: Sequence[int]) -> None:
        for uid in uids:
            self.release_seq(uid)

    def deactivate(self, uid: int) -> None:
        """Sequence interrupted: keep pages resident for a later resume."""
        if uid in self._active:
            self._active.remove(uid)
            self._resident[uid] = None
            self._interrupted.add(uid)

    def deactivate_many(self, uids: Sequence[int]) -> None:
        for uid in uids:
            self.deactivate(uid)

    def purge(self) -> int:
        """Release every sequence — active and resident alike.  The
        fence for a killed or scaled-down replica's pool: afterwards no
        table, donor record, or refcount survives (the pool is as empty
        as at construction).  Returns the number of sequences dropped."""
        uids = list(self.tables)
        for uid in uids:
            self.release_seq(uid)
        return len(uids)

    # -- introspection ----------------------------------------------------

    def max_blocks(self, uids: Sequence[int]) -> int:
        return max((len(self.tables[u]) for u in uids), default=0)

    def resident_uids(self) -> List[int]:
        return list(self._resident)

    def stats_dict(self) -> Dict[str, float]:
        return self.stats.as_dict(self.pool, len(self._resident))

    def check_invariants(self) -> None:
        """Refcount conservation: every reference comes from some table."""
        counted = np.zeros(self.pool.num_pages, np.int64)
        for table in self.tables.values():
            for page in table:
                counted[page] += 1
        assert counted[GARBAGE_PAGE] == 0, "garbage page mapped by a table"
        assert (counted == self.pool.refcount).all(), \
            "page refcounts out of sync with tables"
        in_free = self.pool.free_pages()
        assert in_free + int((counted > 0).sum()) == self.pool.num_pages - 1
