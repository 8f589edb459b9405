"""Rollout utilisation metrics — paper Eq. 4:

    BubbleRatio = sum_k (Q - r_k) * dt_k / (T * Q)

where Q is the engine queue (slot) capacity, r_k the number of running
requests during interval k, dt_k its duration, and T total elapsed time.

Also hosts the serving tier's per-tenant accounting: each tenant gets a
:class:`TenantStat` (arrival / shed / admitted / completed / consumed
counters, token throughput, bubble attribution) whose queue-wait and
end-to-end latency distributions are tracked by :class:`ReservoirQuantile`
— a fixed-size streaming reservoir (Vitter's Algorithm R) with seeded,
platform-stable sampling and no external dependencies.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class MetricsSnapshot:
    """One typed observability record, shared across tiers.

    The orchestrator (``RolloutMetrics.snapshot``), the EngineGroup
    (``cache_stats`` / ``replica_stats``) and the serving tier
    (``ServingOrchestrator.snapshot``) all used to emit ad-hoc duck-typed
    dicts; this unifies them: a ``source`` tag, one flat ordered scalar
    map, and optional nested child records.  ``to_dict()`` is the stable
    wire format benchmarks and ``compare.py`` consume.

    The read-only Mapping surface (``get`` / ``[]`` / ``in`` / ``keys`` /
    iteration / truthiness) covers the flat scalars, so every legacy
    caller that indexed these records as plain dicts — including
    ``dict.update(snapshot)`` and ``RolloutMetrics.record_cache`` — keeps
    working unchanged.
    """
    source: str
    values: Dict[str, float] = dataclasses.field(default_factory=dict)
    children: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- read-only Mapping over the flat scalars ----------------------------

    def __getitem__(self, key: str) -> float:
        return self.values[key]

    def get(self, key: str, default=None):
        return self.values.get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self.values

    def __iter__(self) -> Iterator[str]:
        return iter(self.values)

    def __len__(self) -> int:
        return len(self.values)

    def __bool__(self) -> bool:
        return bool(self.values or self.children)

    def keys(self):
        return self.values.keys()

    def items(self):
        return self.values.items()

    def to_dict(self) -> dict:
        """Plain-dict rendering (scalars first, children nested), stable
        across runs — the benchmark/JSON wire format."""
        out: dict = dict(self.values)
        for key, child in self.children.items():
            out[key] = _render(child)
        return out


def _render(x):
    if isinstance(x, MetricsSnapshot):
        return x.to_dict()
    if isinstance(x, dict):
        return {k: _render(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_render(v) for v in x]
    return x


class ReservoirQuantile:
    """Streaming quantile estimator over a fixed-size uniform reservoir.

    Memory is bounded by ``size`` floats regardless of stream length.
    Up to ``size`` observations the quantiles are exact; beyond that the
    reservoir is a uniform sample (Algorithm R) and quantiles are
    estimates.  Count, mean, min, and max stay exact forever.  The
    replacement draw is seeded by a string, so the same stream produces
    the same reservoir on every platform and process.
    """

    def __init__(self, size: int = 512, seed: "str | int" = 0):
        assert size >= 1
        self.size = size
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._items: List[float] = []
        self._rng = random.Random(f"reservoir:{seed}")

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        if len(self._items) < self.size:
            self._items.append(x)
        else:
            j = self._rng.randrange(self.count)
            if j < self.size:
                self._items[j] = x

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile of the reservoir, q in [0, 1]."""
        if not self._items:
            return 0.0
        xs = sorted(self._items)
        pos = min(max(q, 0.0), 1.0) * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def merge(self, other: "ReservoirQuantile") -> None:
        """Fold another reservoir in (approximate beyond ``size``: the
        merged reservoir is a seeded uniform subsample of the union)."""
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        items = self._items + other._items
        if len(items) > self.size:
            items = self._rng.sample(items, self.size)
        self._items = items

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": round(self.mean, 6),
            "p50": round(self.quantile(0.50), 6),
            "p95": round(self.quantile(0.95), 6),
            "p99": round(self.quantile(0.99), 6),
            "max": round(self.max, 6) if self.count else 0.0,
        }


def _wait_reservoir() -> ReservoirQuantile:
    return ReservoirQuantile(seed="queue_wait")


def _latency_reservoir() -> ReservoirQuantile:
    return ReservoirQuantile(seed="latency")


@dataclasses.dataclass
class TenantStat:
    """Per-tenant serving accounting (conservation:
    ``arrivals == admitted + queued + shed`` at the ingress, and every
    admitted request is eventually completed and consumed)."""
    arrivals: int = 0               # requests delivered to the ingress
    shed: int = 0                   # rejected (queue full / rate limit)
    admitted: int = 0               # moved from tenant queue into the buffer
    completed: int = 0              # finished decoding (eos / length)
    consumed: int = 0               # fed to the trainer
    tokens: int = 0                 # generated tokens kept
    slo_misses: int = 0             # completions past their deadline
    bubble_time: float = 0.0        # idle-slot time while this tenant queued
    queue_wait: ReservoirQuantile = dataclasses.field(
        default_factory=_wait_reservoir)
    latency: ReservoirQuantile = dataclasses.field(
        default_factory=_latency_reservoir)

    def merge(self, other: "TenantStat") -> None:
        self.arrivals += other.arrivals
        self.shed += other.shed
        self.admitted += other.admitted
        self.completed += other.completed
        self.consumed += other.consumed
        self.tokens += other.tokens
        self.slo_misses += other.slo_misses
        self.bubble_time += other.bubble_time
        self.queue_wait.merge(other.queue_wait)
        self.latency.merge(other.latency)

    def summary(self) -> dict:
        return {
            "arrivals": self.arrivals,
            "shed": self.shed,
            "admitted": self.admitted,
            "completed": self.completed,
            "consumed": self.consumed,
            "tokens": self.tokens,
            "slo_misses": self.slo_misses,
            "bubble_time": round(self.bubble_time, 4),
            "queue_wait": self.queue_wait.summary(),
            "latency": self.latency.summary(),
        }


@dataclasses.dataclass
class RolloutMetrics:
    capacity: int
    intervals: List[Tuple[int, float]] = dataclasses.field(default_factory=list)
    tokens_generated: int = 0
    prompts_prefilled: int = 0
    tokens_discarded: int = 0       # on-policy scavenging waste
    harvests: int = 0
    updates: int = 0
    updates_gated: int = 0          # batches vetoed by policy.update_gate
    batch_skipped: int = 0          # entries dropped from update batches
                                    # (entries_to_batch prompt >= max_len)
    # trainer-busy accounting (modeled trainer compute seconds): total is
    # every update's cost; stalled is the un-overlapped part rollout
    # actually waited for.  Serialized hand-off => stalled == total.
    update_time_total: float = 0.0
    update_time_stalled: float = 0.0
    # paged-KV-cache gauges (zero for engines without a page pool)
    prefill_tokens_saved: int = 0   # prefix sharing + resume-without-reprefill
    page_occupancy_peak: float = 0.0
    # multi-replica (EngineGroup) gauges — zero for single engines
    steal_count: int = 0            # resumes migrated off their home replica
    steal_migrations: int = 0       # steals that carried their KV along
    migrated_pages: int = 0         # KV pages moved across replica pools
    packed_entries: int = 0         # drain-phase tail-pack consolidations
    replica_busy: float = 0.0       # time-weighted mean busy-replica count
    replica_bubble_ratio: float = 0.0   # per-replica Eq. 4 on busy replicas
    # chaos / elasticity gauges (fault injection, scale_up/scale_down)
    replica_deaths: int = 0         # replicas lost to injected kills
    rehomed_entries: int = 0        # in-flight entries migrated off a dying
                                    # or scaled-down replica (zero re-prefill)
    rerolled_entries: int = 0       # entries released for a re-roll (no
                                    # survivor could take them)
    scale_events: int = 0           # elastic scale_down + scale_up calls
    residency_dropped: int = 0      # resident KV released with no survivor
                                    # pool to take it (re-prefill on resume)
    # serving-tier per-tenant accounting (empty outside serving runs)
    tenants: Dict[str, TenantStat] = dataclasses.field(default_factory=dict)

    def tenant(self, name: str) -> TenantStat:
        """Get-or-create the per-tenant stat record."""
        st = self.tenants.get(name)
        if st is None:
            st = self.tenants[name] = TenantStat()
        return st

    def record(self, running: int, dt: float, new_tokens: int = 0) -> None:
        if dt > 0:
            self.intervals.append((running, dt))
        self.tokens_generated += new_tokens

    def record_cache(self, stats: Optional[dict]) -> None:
        """Fold an engine's cache_stats() snapshot into the gauges.

        ``prefill_tokens_saved`` mirrors the engine's cumulative counter
        (max, not sum — snapshots of the same counter); occupancy keeps
        its peak."""
        if not stats:
            return
        self.prefill_tokens_saved = max(
            self.prefill_tokens_saved, int(stats.get("prefill_tokens_saved", 0)))
        self.page_occupancy_peak = max(
            self.page_occupancy_peak, float(stats.get("page_occupancy", 0.0)))
        # EngineGroup gauges: cumulative counter (max of snapshots) and
        # running ratios (latest snapshot wins)
        self.steal_count = max(self.steal_count,
                               int(stats.get("steal_count", 0)))
        self.steal_migrations = max(self.steal_migrations,
                                    int(stats.get("steal_migrations", 0)))
        self.migrated_pages = max(self.migrated_pages,
                                  int(stats.get("migrated_pages", 0)))
        self.packed_entries = max(self.packed_entries,
                                  int(stats.get("packed_entries", 0)))
        self.replica_deaths = max(self.replica_deaths,
                                  int(stats.get("replica_deaths", 0)))
        self.rehomed_entries = max(self.rehomed_entries,
                                   int(stats.get("rehomed_entries", 0)))
        self.rerolled_entries = max(self.rerolled_entries,
                                    int(stats.get("rerolled_entries", 0)))
        self.scale_events = max(self.scale_events,
                                int(stats.get("scale_events", 0)))
        self.residency_dropped = max(self.residency_dropped,
                                     int(stats.get("residency_dropped", 0)))
        if "replica_busy" in stats:
            self.replica_busy = float(stats["replica_busy"])
        if "replica_bubble_ratio" in stats:
            self.replica_bubble_ratio = float(stats["replica_bubble_ratio"])

    @property
    def elapsed(self) -> float:
        return sum(dt for _, dt in self.intervals)

    @property
    def bubble_ratio(self) -> float:
        T = self.elapsed
        if T <= 0 or self.capacity <= 0:
            return 0.0
        wasted = sum((self.capacity - r) * dt for r, dt in self.intervals)
        return wasted / (T * self.capacity)

    @property
    def throughput(self) -> float:
        """Output tokens per unit time (kept tokens only)."""
        T = self.elapsed
        return self.tokens_generated / T if T > 0 else 0.0

    @property
    def update_overlap_frac(self) -> float:
        """Share of trainer compute hidden behind continued rollout
        (0 for the serialized hand-off, > 0 under overlap mode)."""
        if self.update_time_total <= 0:
            return 0.0
        return 1.0 - self.update_time_stalled / self.update_time_total

    @property
    def trainer_busy_frac(self) -> float:
        """Trainer compute as a fraction of total rollout wall time."""
        T = self.elapsed
        return self.update_time_total / T if T > 0 else 0.0

    def merge(self, other: "RolloutMetrics") -> None:
        assert other.capacity == self.capacity
        self.intervals.extend(other.intervals)
        self.tokens_generated += other.tokens_generated
        self.prompts_prefilled += other.prompts_prefilled
        self.tokens_discarded += other.tokens_discarded
        self.harvests += other.harvests
        self.updates += other.updates
        self.updates_gated += other.updates_gated
        self.batch_skipped += other.batch_skipped
        self.update_time_total += other.update_time_total
        self.update_time_stalled += other.update_time_stalled
        self.prefill_tokens_saved += other.prefill_tokens_saved
        self.page_occupancy_peak = max(self.page_occupancy_peak,
                                       other.page_occupancy_peak)
        self.steal_count += other.steal_count
        self.steal_migrations += other.steal_migrations
        self.migrated_pages += other.migrated_pages
        self.packed_entries += other.packed_entries
        self.replica_deaths += other.replica_deaths
        self.rehomed_entries += other.rehomed_entries
        self.rerolled_entries += other.rerolled_entries
        self.scale_events += other.scale_events
        self.residency_dropped += other.residency_dropped
        self.replica_busy = max(self.replica_busy, other.replica_busy)
        self.replica_bubble_ratio = max(self.replica_bubble_ratio,
                                        other.replica_bubble_ratio)
        for name, st in other.tenants.items():
            self.tenant(name).merge(st)

    def tenant_summary(self) -> Dict[str, dict]:
        """Per-tenant record incl. throughput over this run's elapsed."""
        T = self.elapsed
        out = {}
        for name in sorted(self.tenants):
            rec = self.tenants[name].summary()
            rec["throughput_tok_per_s"] = round(
                self.tenants[name].tokens / T, 1) if T > 0 else 0.0
            out[name] = rec
        return out

    def snapshot(self, source: str = "rollout") -> MetricsSnapshot:
        """The typed observability record for this run (``summary()`` is
        its plain-dict rendering)."""
        values = {
            "elapsed": round(self.elapsed, 3),
            "bubble_ratio": round(self.bubble_ratio, 4),
            "throughput_tok_per_s": round(self.throughput, 1),
            "tokens_generated": self.tokens_generated,
            "tokens_discarded": self.tokens_discarded,
            "harvests": self.harvests,
            "updates": self.updates,
            "updates_gated": self.updates_gated,
            "batch_skipped": self.batch_skipped,
            "update_time_s": round(self.update_time_total, 4),
            "update_overlap_frac": round(self.update_overlap_frac, 4),
            "trainer_busy_frac": round(self.trainer_busy_frac, 4),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "page_occupancy_peak": round(self.page_occupancy_peak, 4),
            "steal_count": self.steal_count,
            "steal_migrations": self.steal_migrations,
            "migrated_pages": self.migrated_pages,
            "packed_entries": self.packed_entries,
            "replica_deaths": self.replica_deaths,
            "rehomed_entries": self.rehomed_entries,
            "rerolled_entries": self.rerolled_entries,
            "scale_events": self.scale_events,
            "residency_dropped": self.residency_dropped,
            "replica_busy": round(self.replica_busy, 3),
            "replica_bubble_ratio": round(self.replica_bubble_ratio, 4),
        }
        # only serving runs carry tenants — keep non-serving summaries
        # (quickstart output, benchmark rows) byte-stable
        children = ({"tenants": self.tenant_summary()}
                    if self.tenants else {})
        return MetricsSnapshot(source=source, values=values,
                               children=children)

    def summary(self) -> dict:
        return self.snapshot().to_dict()
