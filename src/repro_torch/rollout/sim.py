"""Discrete-event rollout-engine simulator.

Implements the same EngineProtocol as the real SlotEngine but advances a
virtual clock with a decode cost model, so scheduling strategies can be
compared at paper scale (512-sample workloads, 8k generation budgets) on a
CPU box in milliseconds.  The cost model captures why bubbles hurt:

    step_time = t_fixed + t_token * active

Autoregressive decode is HBM-bandwidth bound — ``t_fixed`` (weight +
KV-cache streaming) dominates, so a step with 3 active slots costs almost
as much as a full one; idle slots are pure waste.  Prefill charges
``t_prefill_token`` per prompt token, and ``sync_weights`` charges a
weight-broadcast latency per update.

Hidden generation lengths are sampled per (uid, re-roll) from a pluggable
length distribution; the paper's long-tailed shape (Fig. 1c) is the
default.

Slot state lives in the same :class:`SlotTable` structure the real engine
uses — ``gen_count`` is the tokens generated this occupancy, ``kv_start``
the scavenged prefix carried in, and ``gen_budget`` the (capped) hidden
length target — so ``step()`` shares the engine's vectorized retirement
path and its ascending-slot event order.

Residency & migration
---------------------
With ``kv_residency=True`` the simulator mirrors the paged engine's
resume semantics: interrupted uids stay "resident" and a later resubmit
charges ZERO prefill time (counted in ``resumed_without_prefill`` /
``prefill_tokens_saved``, surfaced via :meth:`cache_stats`).  The default
is off, preserving the pre-residency cost model (every resume re-charges
its prefix) for existing benchmarks.  ``kv_retain_across_sync`` matches
the paged cache's knob: with ``False`` (the on-policy setting) a weight
sync drops every modeled residency, so re-rolls charge a fresh prefill
exactly as :class:`~repro_torch.core.kv_cache.PagedKVCache` would re-run it.
The engine also implements the
optional migration capability (:meth:`export_entry` /
:meth:`import_entry` / :meth:`discard_entry`) the
:class:`~repro_torch.rollout.group.EngineGroup` uses for work stealing and
drain-phase tail packing — migration is FREE here (no pages to copy),
matching the "span copy between pools" the slot engine pays for.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.buffer import BufferEntry
from repro_torch.core.engine_api import SlotTable, StepEvent


def lognormal_lengths(median: float = 1200.0, sigma: float = 0.9,
                      max_len: int = 8192) -> Callable[[random.Random], int]:
    """Long-tailed length distribution matching Fig. 1c's shape: ~80% of
    samples below ~2.5x median, a few percent hitting the budget cap."""
    mu = math.log(median)

    def sample(rng: random.Random) -> int:
        return max(1, min(max_len, int(rng.lognormvariate(mu, sigma))))
    return sample


@dataclasses.dataclass
class SimCostModel:
    t_fixed: float = 20e-3        # s/step: weight+cache streaming (HBM bound)
    t_token: float = 0.05e-3      # s/step/active-slot marginal cost
    t_prefill_token: float = 0.02e-3   # s per prefilled token
    t_sync: float = 0.5           # s per weight sync (trainer -> engine)
    t_update: float = 0.0         # charged externally by the harness

    def step_time(self, active: int) -> float:
        return self.t_fixed + self.t_token * active if active else 0.0


class SimEngine:
    """EngineProtocol implementation over a virtual clock."""

    # resident uids kept per slot of capacity (mirrors EngineGroup's
    # home-map bound): consumed-without-resume uids must not grow forever
    RESIDENT_RETENTION_FACTOR = 4

    def __init__(self, capacity: int, max_gen_len: int = 8192,
                 cost: Optional[SimCostModel] = None,
                 length_sampler: Optional[Callable] = None,
                 resample_on_reroll: bool = False, seed: int = 0,
                 length_table: Optional[Dict[int, int]] = None,
                 kv_residency: bool = False,
                 kv_retain_across_sync: bool = True):
        self.capacity = capacity
        self.max_gen_len = max_gen_len
        self.cost = cost or SimCostModel()
        self.length_sampler = length_sampler or lognormal_lengths(
            max_len=max_gen_len)
        self.resample_on_reroll = resample_on_reroll
        # optional uid -> hidden length override.  Per-uid sampling draws
        # from THIS engine's rng at submit time, so in a multi-replica
        # setup the workload would depend on routing; a shared table
        # pins each entry's length to the entry (a property of the
        # prompt, not of the replica that happens to serve it), which is
        # what balancer comparisons need.
        self.length_table = length_table
        self.kv_residency = kv_residency
        self.kv_retain_across_sync = kv_retain_across_sync
        self.rng = random.Random(seed)
        self.throttle_factor = 1.0
        self._clock = 0.0
        self.slots = SlotTable(capacity)
        # finish reason per slot: True when the hidden target fits the budget
        self._eos = np.zeros(capacity, bool)
        self._target_by_uid: Dict[int, int] = {}
        self._resident: Dict[int, None] = {}       # insertion-ordered LRU
        self.version = 0
        # paged-engine-shaped counters (cache_stats surface)
        self.prefill_tokens_run = 0
        self.prefill_tokens_saved = 0
        self.resumed_without_prefill = 0

    @property
    def clock(self) -> float:
        return self._clock

    def free_slots(self) -> int:
        return self.slots.free_count()

    def active_uids(self) -> List[int]:
        return self.slots.active_uids()

    def sync_weights(self, version: int) -> None:
        if version != self.version:
            self._clock += self.cost.t_sync
            self.version = version
            if not self.kv_retain_across_sync:
                # strict sync (on-policy re-rolls): pre-sync KV must not
                # serve a free resume — same rule as PagedKVCache
                self._resident.clear()

    def _target(self, e: BufferEntry) -> int:
        if self.length_table is not None and e.uid in self.length_table:
            return self.length_table[e.uid]
        if e.uid not in self._target_by_uid or (
                self.resample_on_reroll and not e.generated):
            self._target_by_uid[e.uid] = self.length_sampler(self.rng)
        return self._target_by_uid[e.uid]

    def submit(self, entries: Sequence[BufferEntry], version: int) -> None:
        slots = self.slots.allocate(len(entries))
        targets = np.array([self._target(e) for e in entries], np.int64)
        prefix = np.array([len(e.generated) for e in entries], np.int32)
        plens = np.array([len(e.prompt) for e in entries], np.int64)
        t = self.slots
        t.uid[slots] = [e.uid for e in entries]
        t.active[slots] = True
        t.gen_count[slots] = 0
        t.kv_start[slots] = prefix
        t.gen_budget[slots] = np.minimum(targets, self.max_gen_len)
        self._eos[slots] = targets <= self.max_gen_len
        charged = 0
        for e, rows in zip(entries, (plens + prefix).tolist()):
            if e.uid in self._resident:
                # resident resume: the modeled KV is still warm (paged-
                # engine semantics) — zero prefill charge
                del self._resident[e.uid]
                self.prefill_tokens_saved += rows
                self.resumed_without_prefill += 1
            else:
                charged += rows
        self.prefill_tokens_run += charged
        self._clock += self.cost.t_prefill_token * float(charged)

    def step(self) -> List[StepEvent]:
        t = self.slots
        act = t.active_indices()
        if act.size == 0:
            return []
        self._clock += self.cost.step_time(int(act.size)) * self.throttle_factor
        t.gen_count[act] += 1
        total = t.kv_start[act] + t.gen_count[act]
        done = total >= t.gen_budget[act]
        reasons = np.where(done, np.where(self._eos[act], "eos", "length"),
                           None)
        uids = t.uid[act].tolist()          # read before batched release
        t.release(act[done])
        return [StepEvent(uid=u, token=1, logprob=-1.0, done=d,
                          finish_reason=r)
                for u, d, r in zip(uids, done.tolist(), reasons.tolist())]

    def interrupt(self, uids: Optional[Sequence[int]] = None) -> List[int]:
        sel = self.slots.select(uids)
        out = [int(u) for u in self.slots.uid[sel]]
        self.slots.release(sel)
        if self.kv_residency:
            for uid in out:
                self._resident.pop(uid, None)
                self._resident[uid] = None       # re-insert: LRU recency
            cap = self.RESIDENT_RETENTION_FACTOR * self.capacity
            while len(self._resident) > cap:
                # oldest residency first (consumed-without-resume uids)
                del self._resident[next(iter(self._resident))]
        return out

    # -- fault-tolerance surface (EngineGroup chaos / elasticity) ---------

    def throttle(self, factor: float) -> None:
        """Scale the decode step cost (a degraded replica: thermal
        throttling, a sick host).  1.0 restores nominal speed; prefill
        and sync latencies are left alone — the fault models a slow
        decode loop, not a slow interconnect."""
        self.throttle_factor = float(factor)

    def shutdown(self) -> None:
        """Fence the engine (killed or scaled-down replica): release
        every slot and forget all modeled residency.  Counters survive —
        the work done before the fence was real."""
        self.slots.release(self.slots.active_indices())
        self._resident.clear()

    # -- residency / cache surface (paged-engine-shaped) ------------------

    def drop_resident(self, uid: int) -> bool:
        """Forget a uid's modeled residency (its warm KV is abandoned).
        Returns whether anything was actually held, so callers (the
        group's ``residency_dropped`` gauge) can count real losses."""
        held = uid in self._resident
        self._resident.pop(uid, None)
        return held

    def cache_stats(self) -> Dict[str, float]:
        """Prefill counters in the paged engine's cache_stats shape, so
        sim-replica groups and benchmarks can pin zero-re-prefill resumes
        without a real page pool behind them."""
        return {
            "prefill_tokens_run": float(self.prefill_tokens_run),
            "prefill_tokens_saved": float(self.prefill_tokens_saved),
            "resumed_without_prefill": float(self.resumed_without_prefill),
        }

    # -- migration capability (EngineGroup work stealing / tail packing) --

    def export_entry(self, uid: int) -> Optional[Dict]:
        """Snapshot an in-flight slot (or a resident uid) for migration to
        a peer replica.  Pure read — pair with :meth:`discard_entry` once
        the importer has accepted the handle."""
        sel = np.flatnonzero((self.slots.uid == uid) & self.slots.active)
        if sel.size:
            i = int(sel[0])
            t = self.slots
            return {"engine": "sim", "uid": uid, "active": True,
                    "slot": {"gen_count": int(t.gen_count[i]),
                             "kv_start": int(t.kv_start[i]),
                             "gen_budget": int(t.gen_budget[i]),
                             "eos": bool(self._eos[i])},
                    "target": self._target_by_uid.get(uid)}
        if uid in self._resident:
            return {"engine": "sim", "uid": uid, "active": False,
                    "target": self._target_by_uid.get(uid)}
        return None

    def import_entry(self, handle: Dict) -> bool:
        """Land a migrated entry: an active slot is transplanted verbatim
        (the decode continues exactly where the donor stopped), a resident
        uid becomes resident here.  Free — the simulator has no pages to
        copy.  Returns False (engine unchanged) when it cannot accept."""
        if handle.get("engine") != "sim":
            return False
        if handle["active"]:
            if self.free_slots() <= 0:
                return False
            s = handle["slot"]
            slot = self.slots.allocate(1)
            t = self.slots
            t.uid[slot] = handle["uid"]
            t.active[slot] = True
            t.gen_count[slot] = s["gen_count"]
            t.kv_start[slot] = s["kv_start"]
            t.gen_budget[slot] = s["gen_budget"]
            self._eos[slot] = s["eos"]
        else:
            if not self.kv_residency:
                return False
            self._resident[handle["uid"]] = None
        if handle.get("target") is not None:
            self._target_by_uid[handle["uid"]] = handle["target"]
        return True

    def discard_entry(self, uid: int) -> None:
        """Drop every local trace of a migrated-away uid."""
        sel = self.slots.select([uid])
        if sel.size:
            self.slots.release(sel)
        self._resident.pop(uid, None)
