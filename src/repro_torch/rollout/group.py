"""Data-parallel rollout: an EngineProtocol facade over N engine replicas.

The paper's headline bubble-ratio win gets interesting once rollout is
sharded across multiple engine instances: the long tail of ONE replica
stalls the whole group barrier (Seer's "global load balancing" problem,
RollPacker's tail-rank rebalancing).  :class:`EngineGroup` makes a set of
replicas — SimEngine, SlotEngine, or any other
:class:`~repro_torch.core.engine_api.EngineProtocol` backend, each with its own
KV memory — look like ONE engine, so :class:`RolloutOrchestrator`, every
registered :class:`SchedulerPolicy`, and both conformance suites run
against it unchanged.

Routing
-------
``submit`` routes each entry through a pluggable **balancer** (string
registry, mirroring the policy registry):

* ``least_tokens`` (default) — length-aware: pick the replica with the
  least *estimated outstanding decode tokens*.  The estimate uses the
  same signal the scheduling policies' length keys use — tokens already
  generated (``entry.gen_len``) against an EWMA of observed completion
  lengths — or a caller-supplied ``length_hint(entry)``;
* ``least_loaded`` — fallback when no length signal is wanted: pick the
  replica with the fewest active slots (ties by free slots);
* ``round_robin`` — strawman for the benchmarks.

Two affinities run *before* the balancer:

* **home affinity** — an entry that already lives on a replica (it was
  interrupted there and its KV pages are resident) is routed back home,
  so a scavenged entry resumes with ZERO re-prefill exactly as it would
  on a single paged engine.  When the home replica has no free slot the
  entry migrates to another replica (work stealing — correct, but the
  new replica must re-prefill); each migration is counted in
  ``steal_count``;
* **prefix affinity** — entries of one submit batch that share a prefill
  prefix (a GRPO group) are co-routed so the group's prefix-sharing
  machinery keeps its (G-1)/G prefill saving; cross-batch, a replica
  already holding a donor for the prefix attracts the entry.

Merging
-------
``step()`` steps every busy replica and concatenates the per-replica
event streams in replica order.  Each replica emits in ascending slot
order, so the merged order is deterministic and stable for as long as a
request stays resident — the EngineProtocol event-order contract holds
for the group verbatim.

With ``async_step=True`` the lockstep barrier is dropped: each busy
replica is dispatched on its own clock, and a replica whose decode step
is cheaper than the straggler's fits additional *micro-steps* into the
straggler's one-step window (bounded by ``ASYNC_MAX_MICROSTEPS``)
instead of idling behind it.  The event merger still emits replica-major
(replica order, execution order within a replica), so each uid's token
stream is untouched — one ``step()`` call may just carry more than one
event per uid.

Migration (zero re-prefill)
---------------------------
With ``migrate_kv=True`` the group moves an entry's *resident KV* across
replica pools instead of abandoning it: ``export_entry`` on the donor,
``import_pages`` + buffer copy on the destination (free in the
simulator), counted in ``migrated_pages``.  Work stealing then lands the
stolen entry with its pages already warm — the destination's submit path
resumes it with ZERO re-prefill — and falls back to the old
release-and-re-prefill behaviour only when the destination cannot accept
(dense layout, exhausted pool, strict-sync stale KV).

Drain-phase tail packing
------------------------
``drain_pack=True`` (or ``balancer="drain_pack"``) attacks the tail the
way RollPacker's tail-rank rebalancing does: when pending work no longer
fills the group (free slots survive the orchestrator's fill), in-flight
entries are consolidated onto the fewest replicas that hold them — via
the same migration path, so packed entries keep decoding mid-flight with
zero re-prefill — and the drained replicas go fully idle, dropping out of
``replica_busy`` / ``replica_bubble_ratio`` (released, in the Seer fleet
view).  Packed moves are counted in ``packed_entries``.

Accounting
----------
The group keeps per-replica busy integrals on *replica-local* clocks:

* ``replica_bubble_ratio`` — Eq. 4 evaluated per replica and summed:
  idle-slot time on replicas that are actually running, over their
  running time.  A fully idle replica contributes nothing (a drained
  instance can be released or reassigned — the Seer fleet view), so this
  isolates the waste load balancing can actually fix;
* ``replica_busy`` — time-weighted mean number of busy replicas;
* ``steal_count`` — cumulative home-affinity misses (migrations).

``cache_stats()`` aggregates these with the per-replica paged-KV
counters (``stale_kv_reuses`` et al summed across replicas), so the
orchestrator's existing ``record_cache`` plumbing surfaces them as
RolloutMetrics fields; ``replica_stats()`` keeps the per-replica detail.

Failure tolerance & elasticity
------------------------------
The fleet is no longer immortal.  A :class:`FaultInjector` plan makes a
replica die, stall, or slow at a chosen group step (deterministic under
a seed); faults are applied at the START of ``step()``, before any
replica dispatches.  On replica death the group re-homes the dead
replica's in-flight uids: with ``migrate_kv=True`` the same
export/import path work stealing uses transplants each entry — KV and
all — onto a survivor with a free slot, so it keeps decoding with ZERO
re-prefill (counted in ``rehomed_entries``); entries no survivor can
take are released for a re-roll under the *current* policy version
(``rerolled_entries``, drained by the orchestrator through
``take_failed_uids()`` and scavenged back to PENDING — the buffer's
mode decides what survives, so GRPO group barriers stay intact).  A
dead replica is fenced (slots freed, resident KV dropped) and leaves
``replica_busy`` / ``replica_bubble_ratio`` accounting: it accrues no
further busy or capacity time, exactly like a drained instance in the
Seer fleet view.

``scale_down(r)`` / ``scale_up(engine)`` make the fleet elastic
(``elastic=True``): scaling down is a *graceful* kill — drain-pack the
replica's tail onto survivors via KV migration regardless of
``migrate_kv`` (the move is voluntary, the state is healthy), re-roll
the rest, fence — and scaling up appends a replica that joins at the
group's current weight version and attracts work on the next submit.
The ``weighted_tokens`` balancer routes heterogeneous fleets by
estimated *drain time* (outstanding tokens x observed per-step cost /
slot count), so a replica that steps twice as fast takes
proportionally more work instead of the uniform share ``least_tokens``
would give it.
"""
from __future__ import annotations

from typing import (Callable, Dict, List, Optional, Sequence, Tuple)

from repro_torch.core.buffer import BufferEntry
from repro_torch.core.engine_api import (EngineProtocol, FaultEvent, FaultInjector,
                                   SlotTable, StepEvent)
from repro_torch.core.metrics import MetricsSnapshot

def tenant_of(entry: BufferEntry) -> Optional[str]:
    """The serving tier tags entries with a tenant through their meta
    (``ServeMeta.tenant`` or a plain ``{"tenant": ...}`` dict); entries
    outside the serving tier have none."""
    meta = entry.meta
    t = getattr(meta, "tenant", None)
    if t is None and isinstance(meta, dict):
        t = meta.get("tenant")
    return t


# -----------------------------------------------------------------------------
# balancer registry
# -----------------------------------------------------------------------------

# pick(group, entry, free) -> replica index; `free` is the remaining free
# slots per replica for THIS submit batch (the group decrements as it
# assigns, so balancers never see an already-full replica as available)
Balancer = Callable[["EngineGroup", BufferEntry, List[int]], int]

_BALANCERS: Dict[str, Callable[..., Balancer]] = {}


def register_balancer(name: str):
    def deco(factory):
        _BALANCERS[name] = factory
        return factory
    return deco


def make_balancer(name: str, **kwargs) -> Balancer:
    if name not in _BALANCERS:
        raise KeyError(f"unknown balancer {name!r}; "
                       f"registered: {available_balancers()}")
    return _BALANCERS[name](**kwargs)


def available_balancers() -> List[str]:
    return sorted(_BALANCERS)


@register_balancer("least_tokens")
def least_tokens_balancer() -> Balancer:
    """Length-aware default: least estimated outstanding decode tokens.
    Occupancy ties break on ``capacity - free``, which (unlike the live
    active counts) already reflects this batch's earlier assignments."""
    def pick(group: "EngineGroup", entry: BufferEntry,
             free: List[int]) -> int:
        return min((i for i in range(len(free)) if free[i] > 0),
                   key=lambda i: (group.load[i],
                                  group.replicas[i].capacity - free[i], i))
    return pick


@register_balancer("least_loaded")
def least_loaded_balancer() -> Balancer:
    """Length-blind fallback: fewest occupied slots.  Occupancy is
    ``capacity - free`` so in-batch assignments (only visible through
    the decremented ``free``) count — the replicas themselves are not
    submitted to until routing finishes."""
    def pick(group: "EngineGroup", entry: BufferEntry,
             free: List[int]) -> int:
        return min((i for i in range(len(free)) if free[i] > 0),
                   key=lambda i: (group.replicas[i].capacity - free[i], i))
    return pick


@register_balancer("round_robin")
def round_robin_balancer() -> Balancer:
    """Benchmark strawman: cycle replicas, skipping full ones."""
    state = {"next": 0}

    def pick(group: "EngineGroup", entry: BufferEntry,
             free: List[int]) -> int:
        n = len(free)
        for k in range(n):
            i = (state["next"] + k) % n
            if free[i] > 0:
                state["next"] = (i + 1) % n
                return i
        raise AssertionError("round_robin: no free replica")
    return pick


@register_balancer("weighted_tokens")
def weighted_tokens_balancer() -> Balancer:
    """Throughput-weighted routing for heterogeneous fleets: least
    estimated *drain time* — outstanding tokens times the replica's
    observed per-step cost, normalised by slot count — so a replica
    that steps twice as fast (or is twice as wide) attracts
    proportionally more work.  Until a replica's step cost has been
    observed it assumes the fleet mean, which makes the cold-start
    routing identical to ``least_tokens``."""
    def pick(group: "EngineGroup", entry: BufferEntry,
             free: List[int]) -> int:
        def drain(i: int):
            cap = max(1, group.replicas[i].capacity)
            return ((group.load[i] + 1.0) * group.replica_step_cost(i) / cap,
                    group.replicas[i].capacity - free[i], i)
        return min((i for i in range(len(free)) if free[i] > 0), key=drain)
    return pick


@register_balancer("drain_pack")
def drain_pack_balancer() -> Balancer:
    """Length-aware routing + drain-phase tail packing: routes exactly
    like ``least_tokens`` but flags the group to consolidate the in-
    flight tail onto the fewest replicas (via KV migration) once pending
    work no longer fills the group."""
    pick = least_tokens_balancer()
    pick.drain_pack = True
    return pick


# -----------------------------------------------------------------------------
# the group
# -----------------------------------------------------------------------------

# affinity records kept per slot of group capacity: uids that were
# scavenged and trained (never resubmitted) must not grow _home forever
HOME_RETENTION_FACTOR = 4

# async stepping: cap on decode micro-steps one replica may run inside a
# single group step.  The catch-up loop projects the next micro-step from
# the last observed dt; real-engine wall clocks jitter, so an explicit
# bound keeps one noisy estimate from turning into a runaway inner loop.
ASYNC_MAX_MICROSTEPS = 4


class EngineGroup:
    """N engine replicas behind the single-engine EngineProtocol surface.

    ``async_step`` drops the lockstep step barrier (micro-step catch-up
    on replica-local clocks), ``migrate_kv`` moves resident KV across
    replica pools so stolen entries resume with zero re-prefill, and
    ``drain_pack`` consolidates the in-flight tail onto the fewest
    replicas once pending work stops filling the group (implies
    ``migrate_kv``; also enabled by ``balancer="drain_pack"``).  All
    three default off, preserving PR-4 lockstep semantics exactly.

    ``fault_injector`` attaches a deterministic chaos plan (kill /
    stall / slow per replica, see the module docstring) and
    ``elastic=True`` enables :meth:`scale_down` / :meth:`scale_up`;
    both default off — a plain group is the PR-4 immortal fixed fleet.
    """

    def __init__(self, replicas: Sequence[EngineProtocol],
                 balancer: "str | Balancer" = "least_tokens",
                 length_hint: Optional[Callable[[BufferEntry], float]] = None,
                 async_step: bool = False,
                 drain_pack: Optional[bool] = None,
                 migrate_kv: Optional[bool] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 elastic: bool = False,
                 spread_tenants: bool = False):
        assert replicas, "EngineGroup needs at least one replica"
        self.replicas = list(replicas)
        self.balancer = (make_balancer(balancer)
                         if isinstance(balancer, str) else balancer)
        self.length_hint = length_hint
        self.async_step = async_step
        if drain_pack is None:
            drain_pack = bool(getattr(self.balancer, "drain_pack", False))
        self.drain_pack = drain_pack
        # packing moves in-flight entries, which only makes sense with
        # their KV; stealing can opt in independently
        self.migrate_kv = drain_pack if migrate_kv is None else migrate_kv
        self.version = 0
        n = len(self.replicas)
        # group wall clock: replicas run concurrently, so each submit /
        # step / sync advances the group by the MAX of the per-replica
        # clock deltas it caused (monotone by construction).  Taking the
        # running max of raw replica clocks instead would freeze while a
        # drained fast replica holds the max and lump-attribute laggards'
        # busy time later — distorting every dt the orchestrator records.
        self._clock = max(r.clock for r in self.replicas)
        # routing state
        # tenant-tagged routing (serving tier): when on, fresh entries of
        # one tenant are spread across replicas so a bursty tenant cannot
        # monopolise a single replica's slots (fate sharing / noisy
        # neighbour isolation).  Off by default — RL workloads have no
        # tenants and the extra key would be pure overhead.
        self.spread_tenants = spread_tenants
        self._tenant_by_uid: Dict[int, str] = {}
        self._home: Dict[int, int] = {}        # uid -> replica index
        self._est: Dict[int, float] = {}       # uid -> est remaining tokens
        self._gen_total: Dict[int, int] = {}   # uid -> generated incl prefix
        self.load: List[float] = [0.0] * n     # sum of _est per replica
        self.steal_count = 0
        self.steal_migrations = 0              # steals that moved their KV
        self.packed_entries = 0                # drain-pack consolidations
        self._submitted_since_step = False     # drain detection (see step)
        self._ewma_len: Optional[float] = None  # observed completion length
        self._max_gen = max((getattr(r, "max_gen_len", 0)
                             for r in self.replicas), default=0) or 1024
        # per-replica busy integrals over replica-local stepped time
        self._busy_time = [0.0] * n            # sum busy_slots * dt
        self._cap_time = [0.0] * n             # sum capacity   * dt
        self._busy_replicas_time = 0.0         # sum busy_replica_count * dt
        self._stepped_time = 0.0               # sum group-step dt (max over r)
        # fault tolerance / elasticity
        self.fault_injector = fault_injector
        self.elastic = elastic
        self.alive: List[bool] = [True] * n
        self._step_index = 0                   # 1-based after first step()
        self._stall_until = [0] * n            # last stalled step, inclusive
        self._slow_until = [0] * n             # last throttled step, inclusive
        self._dt_ewma: List[Optional[float]] = [None] * n  # per-step cost
        self._failed_uids: List[int] = []      # await re-roll by the caller
        self.replica_deaths = 0
        self.rehomed_entries = 0               # migrated off a dying replica
        self.rerolled_entries = 0              # released: no survivor took it
        self.scale_events = 0                  # scale_down + scale_up calls
        self.residency_dropped = 0             # resident KV released unread

    # -- protocol: time & slot queries ------------------------------------

    @property
    def capacity(self) -> int:
        """Q of the *live* fleet: dead / scaled-down replicas stop
        counting, so the orchestrator's fill and the policies' capacity-
        relative thresholds track what can actually decode."""
        return sum(r.capacity
                   for i, r in enumerate(self.replicas) if self.alive[i])

    @property
    def clock(self) -> float:
        """Modeled-concurrent group wall clock (see __init__)."""
        return self._clock

    def _alive_indices(self) -> List[int]:
        return [i for i, a in enumerate(self.alive) if a]

    def free_slots(self) -> int:
        return sum(self.replicas[i].free_slots()
                   for i in self._alive_indices())

    def active_uids(self) -> List[int]:
        out: List[int] = []
        for i in self._alive_indices():
            out.extend(self.replicas[i].active_uids())
        return out

    @property
    def active_counts(self) -> List[int]:
        # one entry per replica, dead included (fenced replicas read 0)
        return [len(r.active_uids()) for r in self.replicas]

    @property
    def slots(self) -> SlotTable:
        """Read-only aggregate host-state snapshot: the live replicas'
        SlotTable rows concatenated in replica order (mutations do not
        propagate)."""
        view = SlotTable(self.capacity)
        off = 0
        for i in self._alive_indices():
            t = self.replicas[i].slots
            for name in ("uid", "active", "next_token", "kv_len", "kv_start",
                         "gen_count", "gen_budget"):
                getattr(view, name)[off:off + t.capacity] = getattr(t, name)
            off += t.capacity
        return view

    # -- routing ----------------------------------------------------------

    def _hint(self, entry: BufferEntry) -> float:
        if self.length_hint is not None:
            return max(1.0, float(self.length_hint(entry)))
        expect = (self._ewma_len if self._ewma_len is not None
                  else 0.5 * self._max_gen)
        return max(1.0, expect - entry.gen_len)

    def _prefill_key(self, entry: BufferEntry) -> Tuple[int, ...]:
        seq = list(entry.prompt) + list(entry.generated)
        return tuple(seq[:-1])

    def _drop_donor_residency(self, replica: int, uid: int) -> bool:
        """Abandoned resident state is dead weight on the donor replica —
        release it explicitly (paged pool pages, or the simulator's
        modeled residency) instead of letting it crowd the pool until LRU
        pressure reaches it.  Returns True (and counts it in the
        ``residency_dropped`` gauge) when something was actually held:
        losing resident KV means the uid re-prefills from scratch on its
        next run, a cost the fleet operator should be able to see."""
        if not self.alive[replica]:
            return False                # fenced: nothing resident to drop
        r = self.replicas[replica]
        dropped = False
        kv = getattr(r, "kv", None)
        if kv is not None:
            if uid in kv.tables:
                dropped = True
            kv.release_seq(uid)
        drop = getattr(r, "drop_resident", None)
        if drop is not None and drop(uid):
            dropped = True
        if dropped:
            self.residency_dropped += 1
        return dropped

    def _remember_home(self, uid: int, replica: int) -> None:
        """Record the uid's home (insertion order doubles as recency) and
        bound the map: consumed-without-resume uids would otherwise leak
        one record per scavenged trajectory for the engine's lifetime."""
        self._home.pop(uid, None)
        self._home[uid] = replica
        cap = HOME_RETENTION_FACTOR * self.capacity
        if len(self._home) <= cap:
            return
        live = set(self.active_uids())
        for u in list(self._home):
            if len(self._home) <= cap:
                break
            if u in live:
                continue
            # forgetting a home abandons any KV still resident there
            self._drop_donor_residency(self._home[u], u)
            del self._home[u]

    def _migrate(self, uid: int, src: int, dst: int) -> bool:
        """Move `uid` (in-flight slot or resident KV) from replica `src`
        to `dst` through the engines' optional migration capability.
        Export -> import -> discard: the donor copy survives until the
        importer has accepted, so False always means 'nothing changed'."""
        export = getattr(self.replicas[src], "export_entry", None)
        accept = getattr(self.replicas[dst], "import_entry", None)
        if export is None or accept is None:
            return False
        handle = export(uid)
        if handle is None or not accept(handle):
            return False
        self.replicas[src].discard_entry(uid)
        return True

    def _resident_replica(self, key: Tuple[int, ...]) -> Optional[int]:
        """Replica already holding a donor for this prefill prefix."""
        for i in self._alive_indices():
            kv = getattr(self.replicas[i], "kv", None)
            if kv is not None and kv.find_donor(key) is not None:
                return i
        return None

    def _pick_fresh(self, entry: BufferEntry, free: List[int],
                    key_dest: Dict[Tuple[int, ...], int],
                    tenant_scratch: Optional[Dict] = None) -> int:
        """Prefix co-routing, then tenant spreading (when enabled), then
        the balancer (no home affinity)."""
        key = self._prefill_key(entry)
        if key:      # an empty prefix is never shared — don't co-route on it
            dest = key_dest.get(key)
            if dest is None:
                dest = self._resident_replica(key)
            if dest is not None and free[dest] > 0:
                return dest
        if self.spread_tenants:
            t = tenant_of(entry)
            if t is not None:
                scratch = tenant_scratch or {}

                def same(i: int) -> int:
                    live = sum(1 for u in self.replicas[i].active_uids()
                               if self._tenant_by_uid.get(u) == t)
                    return live + scratch.get((i, t), 0)
                # fewest same-tenant entries wins; the balancer's choice
                # breaks ties, so within a tenant routing stays length- /
                # load-aware
                best = self.balancer(self, entry, free)
                return min((i for i in range(len(free)) if free[i] > 0),
                           key=lambda i: (same(i), i != best, i))
        return self.balancer(self, entry, free)

    def _route(self, entry: BufferEntry, free: List[int],
               key_dest: Dict[Tuple[int, ...], int],
               tenant_scratch: Optional[Dict] = None) -> int:
        home = self._home.get(entry.uid)
        if home is not None and not self.alive[home]:
            # the home died after this record was written (kill/scale
            # cleanup removes records eagerly, but a record can reappear
            # stale through caller-held handles): nothing is resident
            # there any more — treat as fresh
            self._home.pop(entry.uid, None)
            home = None
        if home is None:
            return self._pick_fresh(entry, free, key_dest, tenant_scratch)
        if free[home] > 0:
            return home
        self.steal_count += 1              # migrate: home replica is full
        dest = self._pick_fresh(entry, free, key_dest, tenant_scratch)
        if self.migrate_kv and self._migrate(entry.uid, home, dest):
            # the entry lands on the thief with its KV resident: the
            # destination's submit path resumes it with zero re-prefill
            self.steal_migrations += 1
        else:
            # fallback: the thief re-prefills, so any KV left resident on
            # the old home is dead weight — drop it instead of letting it
            # crowd the pool until LRU pressure gets to it
            self._drop_donor_residency(home, entry.uid)
        return dest

    # -- protocol: submit / step / interrupt / sync -----------------------

    def submit(self, entries: Sequence[BufferEntry], version: int) -> None:
        if not entries:
            return
        # dead / scaled-down replicas advertise zero free slots, so no
        # balancer (round_robin and least_loaded included) can route a
        # late-arriving submit onto a fenced replica; drained-but-ALIVE
        # replicas keep their free slots and rejoin on new work
        free = [r.free_slots() if self.alive[i] else 0
                for i, r in enumerate(self.replicas)]
        assert len(entries) <= sum(free), "not enough free slots"
        batches: List[List[BufferEntry]] = [[] for _ in self.replicas]
        key_dest: Dict[Tuple[int, ...], int] = {}
        tenant_scratch: Dict = {}   # (replica, tenant) -> in-batch count
        # two passes: home-affine (previously-seen) entries claim their
        # home slots FIRST, so a fresh entry earlier in the caller's
        # order cannot take the last free slot of a resumable entry's
        # home replica and force an avoidable steal
        order = sorted(range(len(entries)),
                       key=lambda j: entries[j].uid not in self._home)
        for j in order:
            e = entries[j]
            i = self._route(e, free, key_dest, tenant_scratch)
            assert free[i] > 0, (i, free)
            free[i] -= 1
            key = self._prefill_key(e)
            if key:
                key_dest.setdefault(key, i)
            t = tenant_of(e)
            if t is not None:
                self._tenant_by_uid[e.uid] = t
                tenant_scratch[(i, t)] = tenant_scratch.get((i, t), 0) + 1
            batches[i].append(e)
            # account the assignment NOW so the balancer sees in-batch
            # routing decisions, not just the pre-submit loads
            est = self._hint(e)
            self._remember_home(e.uid, i)
            self._est[e.uid] = est
            self._gen_total[e.uid] = e.gen_len
            self.load[i] += est
        cap = HOME_RETENTION_FACTOR * max(1, self.capacity)
        if len(self._tenant_by_uid) > cap:
            # bound the tag map (mirrors _remember_home): tags of consumed
            # uids must not leak one record per request forever
            live = set(self.active_uids()) | set(self._home)
            live.update(e.uid for e in entries)
            self._tenant_by_uid = {u: t for u, t in self._tenant_by_uid.items()
                                   if u in live}
        dt_group = 0.0
        for i, batch in enumerate(batches):
            if batch:
                t0 = self.replicas[i].clock
                self.replicas[i].submit(batch, version)
                dt_group = max(dt_group, self.replicas[i].clock - t0)
        self._clock += dt_group        # per-replica prefills run concurrently
        self._submitted_since_step = True

    def _micro_step(self, i: int) -> Tuple[List[StepEvent], float]:
        """One decode step on replica `i` with full event accounting."""
        r = self.replicas[i]
        t0 = r.clock
        evs = r.step()
        dt = r.clock - t0
        self._busy_time[i] += len(evs) * dt
        self._cap_time[i] += r.capacity * dt
        if dt > 0:
            # observed per-step cost, fed to the weighted_tokens balancer
            d = self._dt_ewma[i]
            self._dt_ewma[i] = dt if d is None else 0.8 * d + 0.2 * dt
        for ev in evs:
            if self._est.get(ev.uid, 0.0) >= 1.0:
                self._est[ev.uid] -= 1.0
                self.load[i] -= 1.0
            self._gen_total[ev.uid] = self._gen_total.get(ev.uid, 0) + 1
            if ev.done:
                self._finish(ev.uid, i)
        return evs, dt

    def step(self) -> List[StepEvent]:
        # faults fire at the step boundary, before any replica dispatches
        self._step_index += 1
        if self.fault_injector is not None:
            for f in self.fault_injector.due(self._step_index):
                self._apply_fault(f)
        for i in self._alive_indices():
            if self._slow_until[i] and self._step_index > self._slow_until[i]:
                self.replicas[i].throttle(1.0)   # degradation window over
                self._slow_until[i] = 0
        # pack only when no work arrived since the previous step: the
        # orchestrator fills before every step, so a quiet interval with
        # free slots means pending is genuinely dry (drain), while a
        # policy that is still admitting (group-barrier gating, lookahead)
        # keeps the flag set and avoids pack/redistribute churn
        if self.drain_pack and not self._submitted_since_step:
            self._maybe_pack()
        self._submitted_since_step = False
        # a stalled replica holds its entries but makes no progress this
        # step (and accrues no busy/capacity time: it is wedged, not
        # bubbling); a dead one is out of the fleet entirely
        busy = [i for i, r in enumerate(self.replicas)
                if self.alive[i] and self._step_index > self._stall_until[i]
                and r.active_uids()]
        if not busy:
            return []
        streams: List[List[StepEvent]] = []
        spent: List[float] = []                 # per-replica in-call time
        last_dt: List[float] = []
        for i in busy:
            evs, dt = self._micro_step(i)
            streams.append(evs)
            spent.append(dt)
            last_dt.append(dt)
        if self.async_step:
            # no step barrier: while the straggler's single step runs, a
            # replica with a cheaper step fits extra micro-steps into the
            # same window (projected from its last observed dt)
            horizon = max(spent)
            for _ in range(ASYNC_MAX_MICROSTEPS - 1):
                progressed = False
                for k, i in enumerate(busy):
                    if not self.replicas[i].active_uids():
                        continue
                    if last_dt[k] <= 0 or spent[k] + last_dt[k] > horizon:
                        continue
                    evs, dt = self._micro_step(i)
                    streams[k].extend(evs)
                    spent[k] += dt
                    last_dt[k] = dt
                    progressed = True
                if not progressed:
                    break
        # replica-major merge: replica order, execution order within one
        events = [ev for stream in streams for ev in stream]
        dt_group = max(spent)           # replicas overlap in time
        self._busy_replicas_time += len(busy) * dt_group
        self._stepped_time += dt_group
        self._clock += dt_group
        return events

    def _maybe_pack(self) -> None:
        """Drain-phase tail packing: once pending work no longer fills the
        group (free slots survived the orchestrator's fill), consolidate
        the in-flight tail onto the fewest replicas that can hold it and
        let the drained replicas go idle (released from the busy set)."""
        active = [len(r.active_uids()) if self.alive[i] else 0
                  for i, r in enumerate(self.replicas)]
        total = sum(active)
        if total == 0 or total >= self.capacity:
            return                      # empty, or pending still fills us
        busy = [i for i, a in enumerate(active) if a > 0]
        # fewest replicas (most-loaded first: they move the least) that
        # can hold every in-flight entry
        order = sorted(busy, key=lambda i: (-active[i], i))
        keep: List[int] = []
        cap = 0
        for i in order:
            keep.append(i)
            cap += self.replicas[i].capacity
            if cap >= total:
                break
        if len(keep) >= len(busy):
            return                      # already as consolidated as it gets
        keep_set = set(keep)
        room = {i: self.replicas[i].capacity - active[i] for i in keep}
        donors = sorted((i for i in busy if i not in keep_set),
                        key=lambda i: (active[i], i))
        for d in donors:
            export = getattr(self.replicas[d], "export_entry", None)
            if export is None:
                return                  # backend cannot migrate — leave it
            for uid in list(self.replicas[d].active_uids()):
                handle = export(uid)
                if handle is None:
                    return              # backend cannot migrate — leave it
                # one export, every willing destination: a destination-
                # local failure (exhausted page pool) must not strand the
                # tail when another keep replica still has room
                dst = None
                for i in (i for i in keep if room[i] > 0):
                    accept = getattr(self.replicas[i], "import_entry", None)
                    if accept is not None and accept(handle):
                        dst = i
                        break
                if dst is None:
                    return              # nobody can take it now — retry on
                                        # a later step once pressure eases
                self.replicas[d].discard_entry(uid)
                room[dst] -= 1
                est = self._est.get(uid, 0.0)
                self.load[d] = max(0.0, self.load[d] - est)
                self.load[dst] += est
                self._remember_home(uid, dst)
                self.packed_entries += 1

    # -- fault handling & elasticity --------------------------------------

    def _apply_fault(self, f: FaultEvent) -> None:
        i = f.replica
        if i >= len(self.replicas) or not self.alive[i]:
            return                      # already dead, or never existed
        if f.kind == "kill":
            self._kill_replica(i)
        elif f.kind == "stall":
            self._stall_until[i] = max(self._stall_until[i],
                                       self._step_index + f.duration - 1)
        elif f.kind == "slow":
            throttle = getattr(self.replicas[i], "throttle", None)
            if throttle is not None:    # wall-clock engines can't be modeled
                throttle(f.factor)
                self._slow_until[i] = max(self._slow_until[i],
                                          self._step_index + f.duration - 1)

    def _kill_replica(self, i: int) -> None:
        """Fail-stop replica death, detected at the step boundary.  Every
        in-flight uid is re-homed onto a survivor (KV transplanted, zero
        re-prefill) when ``migrate_kv`` and a survivor has room;
        otherwise it is released for a re-roll under the current policy
        version (its tokens so far were already reported through
        ``step()``, so the buffer's mode decides what survives)."""
        r = self.replicas[i]
        self.alive[i] = False
        self.replica_deaths += 1
        for uid in list(r.active_uids()):
            if self.migrate_kv and self._rehome(uid, i) is not None:
                # a survivor had a free slot: the entry keeps decoding
                # there, no rescheduling needed
                self.rehomed_entries += 1
            elif self.migrate_kv and self._rehome_resident(uid, i):
                # the fleet runs full (no survivor slot free), but the KV
                # fits a survivor's pool as RESIDENT state: hand the uid
                # back for rescheduling — it routes home to the new
                # replica and resumes with zero re-prefill
                self.rehomed_entries += 1
                self._reschedule(uid)
            else:
                self._release_for_reroll(uid)
        self._fence(i)

    def _rehome_resident(self, uid: int, src: int) -> bool:
        """Migrate `uid`'s KV to a survivor as resident (non-active)
        state: interrupt it on the dying replica (slot -> residency),
        then export/import the resident handle.  Needs pool room on the
        destination, not a free slot."""
        self.replicas[src].interrupt([uid])
        for dst in self._alive_indices():
            if dst != src and self._migrate(uid, src, dst):
                self._remember_home(uid, dst)
                return True
        return False

    def _reschedule(self, uid: int) -> None:
        """Hand a re-homed-as-resident uid back to the caller for a
        resubmit (``take_failed_uids``).  Unlike a re-roll its home and
        KV survive, so the resume is free."""
        self._failed_uids.append(uid)
        self._est.pop(uid, None)
        self._gen_total.pop(uid, None)

    def _rehome(self, uid: int, src: int) -> Optional[int]:
        """Transplant `uid` from replica `src` onto the emptiest survivor
        that accepts it (export -> import -> discard, the work-stealing
        path); returns the destination, or None when nobody can take it
        now.  Load and home-affinity records follow the entry."""
        order = sorted(self._alive_indices(),
                       key=lambda j: (len(self.replicas[j].active_uids()), j))
        for dst in order:
            if dst == src or self.replicas[dst].free_slots() <= 0:
                continue
            if self._migrate(uid, src, dst):
                est = self._est.get(uid, 0.0)
                self.load[src] = max(0.0, self.load[src] - est)
                self.load[dst] += est
                self._remember_home(uid, dst)
                return dst
        return None

    def _release_for_reroll(self, uid: int) -> None:
        """No survivor could take the uid: surrender it to the caller
        (``take_failed_uids``) for a re-roll under the current policy
        version, and forget every routing record (its engine-side state
        is gone)."""
        self._failed_uids.append(uid)
        self.rerolled_entries += 1
        self._est.pop(uid, None)
        self._gen_total.pop(uid, None)
        self._home.pop(uid, None)

    def _fence(self, i: int) -> None:
        """Seal off a dead or scaled-down replica: forget residency
        records that point at it, zero its routing load, and release its
        engine-side state so the fleet holds no references to it."""
        for uid, h in list(self._home.items()):
            if h == i:                  # pages died with the replica
                del self._home[uid]
        self.load[i] = 0.0
        r = self.replicas[i]
        shutdown = getattr(r, "shutdown", None)
        if shutdown is not None:
            shutdown()
        else:
            r.interrupt()

    def take_failed_uids(self) -> List[int]:
        """Drain the uids whose replica died (or scaled away) without a
        survivor able to take them.  Their engine-side state is gone;
        the caller must re-roll them — the orchestrator scavenges each
        back to PENDING, so on-policy mode discards its tokens and
        partial mode keeps them, exactly the interrupt rule."""
        out, self._failed_uids = self._failed_uids, []
        return out

    def scale_down(self, i: int) -> None:
        """Elastically release replica `i`: a graceful kill.  Its
        in-flight tail drain-packs onto the survivors through the same
        export/import path (the move is voluntary and the state healthy,
        so migration is attempted regardless of ``migrate_kv``), entries
        no survivor can hold are re-rolled, resident KV follows where it
        can, and the replica is fenced out of capacity and accounting."""
        assert self.elastic, "scale_down requires EngineGroup(elastic=True)"
        assert self.alive[i], f"replica {i} is not alive"
        assert sum(self.alive) > 1, "cannot scale down the last live replica"
        r = self.replicas[i]
        for uid in list(r.active_uids()):
            if self._rehome(uid, i) is not None:
                self.rehomed_entries += 1
            elif self._rehome_resident(uid, i):
                # survivors are slot-full: park the KV on one of them as
                # resident state and hand the uid back for a resubmit
                self.rehomed_entries += 1
                self._reschedule(uid)
            else:
                self._release_for_reroll(uid)
        # interrupted-but-resident uids keep their zero-re-prefill resume
        # where a survivor can host the pages
        for uid, h in list(self._home.items()):
            if h != i:
                continue
            for dst in self._alive_indices():
                if dst != i and self._migrate(uid, i, dst):
                    self._remember_home(uid, dst)
                    break
            else:
                # no survivor pool accepted: the pages are gone either
                # way, but release them explicitly (counted in
                # residency_dropped) instead of letting the fence wipe
                # them without trace — the uid re-prefills on resume
                self._drop_donor_residency(i, uid)
                del self._home[uid]
        self.alive[i] = False
        self.scale_events += 1
        self._fence(i)

    def scale_up(self, engine: EngineProtocol) -> int:
        """Elastically add a replica; returns its index.  It joins at
        the group's current weight version and advertises its free slots
        immediately, so new work routes onto it on the next submit (and
        ``weighted_tokens`` learns its speed from its first steps)."""
        assert self.elastic, "scale_up requires EngineGroup(elastic=True)"
        i = len(self.replicas)
        self.replicas.append(engine)
        self.alive.append(True)
        self.load.append(0.0)
        self._busy_time.append(0.0)
        self._cap_time.append(0.0)
        self._dt_ewma.append(None)
        self._stall_until.append(0)
        self._slow_until.append(0)
        engine.sync_weights(self.version)
        self._clock = max(self._clock, engine.clock)
        self._max_gen = max(self._max_gen,
                            getattr(engine, "max_gen_len", 0)) or self._max_gen
        self.scale_events += 1
        return i

    def replica_step_cost(self, i: int) -> float:
        """Observed per-decode-step cost of replica `i` (EWMA of its
        replica-local step dt).  A replica not yet observed assumes the
        fleet mean — and 1.0 before any observation at all, which makes
        every replica equal (cold-start parity with ``least_tokens``)."""
        d = self._dt_ewma[i]
        if d is not None and d > 0:
            return d
        known = [x for x in self._dt_ewma if x is not None and x > 0]
        return sum(known) / len(known) if known else 1.0

    def _finish(self, uid: int, replica: int) -> None:
        total = self._gen_total.pop(uid, 0)
        self._ewma_len = (float(total) if self._ewma_len is None
                          else 0.9 * self._ewma_len + 0.1 * total)
        self.load[replica] -= self._est.pop(uid, 0.0)
        self.load[replica] = max(0.0, self.load[replica])
        self._home.pop(uid, None)

    def interrupt(self, uids: Optional[Sequence[int]] = None) -> List[int]:
        out: List[int] = []
        targets = None if uids is None else set(uids)
        for i, r in enumerate(self.replicas):
            if not self.alive[i]:
                continue        # fenced: nothing left there to stop
            if targets is not None:
                # target the CURRENT holder: a steal or pack migration
                # may have moved a uid off the replica the home-affinity
                # map last recorded, so holders are resolved from live
                # slot state — never from _home, which this path once
                # indexed (the historical re-homing bug: interrupting a
                # migrated uid hit its stale home and missed the entry)
                held = targets.intersection(r.active_uids())
                if not held:
                    continue
                got = r.interrupt(sorted(held))
            else:
                got = r.interrupt()
            for uid in got:
                # keep _home: resident pages make this replica the uid's
                # zero-re-prefill resume target
                self.load[i] -= self._est.pop(uid, 0.0)
                self.load[i] = max(0.0, self.load[i])
                self._gen_total.pop(uid, None)
            out.extend(got)
        return out

    def sync_weights(self, version: int) -> None:
        """Version-stamped broadcast: every replica syncs (its paged KV
        stamps/invalidates per its retain_across_sync setting).  The
        broadcasts overlap, so the group pays the slowest replica's
        sync latency once."""
        dt_group = 0.0
        for i in self._alive_indices():
            r = self.replicas[i]
            t0 = r.clock
            r.sync_weights(version)
            dt_group = max(dt_group, r.clock - t0)
        self._clock += dt_group
        self.version = version

    # -- observability ----------------------------------------------------

    @property
    def replica_bubble_ratio(self) -> float:
        """Per-replica Eq. 4, summed over replicas on replica-local time:
        idle-slot time of *running* replicas over their running time.
        Fully idle replicas count as released, not as bubble."""
        cap = sum(self._cap_time)
        if cap <= 0:
            return 0.0
        return (cap - sum(self._busy_time)) / cap

    @property
    def replica_busy(self) -> float:
        """Time-weighted mean number of simultaneously busy replicas."""
        if self._stepped_time <= 0:
            return 0.0
        return self._busy_replicas_time / self._stepped_time

    def tenant_counts(self) -> List[Dict[str, int]]:
        """Per-replica active-entry count by tenant (serving-tier
        observability; empty dicts outside serving runs).  Dead replicas
        report empty — they are fenced and hold nothing."""
        out: List[Dict[str, int]] = []
        for i, r in enumerate(self.replicas):
            d: Dict[str, int] = {}
            if self.alive[i]:
                for u in r.active_uids():
                    t = self._tenant_by_uid.get(u)
                    if t is not None:
                        d[t] = d.get(t, 0) + 1
            out.append(d)
        # opportunistic prune: tags of long-gone uids must not grow the
        # map forever in an unbounded serving run
        cap = HOME_RETENTION_FACTOR * max(1, self.capacity)
        if len(self._tenant_by_uid) > cap:
            live = set(self.active_uids()) | set(self._home)
            self._tenant_by_uid = {u: t for u, t in self._tenant_by_uid.items()
                                   if u in live}
        return out

    def replica_stats(self) -> List[MetricsSnapshot]:
        """Per-replica detail behind the aggregated ``cache_stats()``,
        one :class:`MetricsSnapshot` per replica (Mapping-compatible, so
        legacy dict-indexing callers are unaffected)."""
        out = []
        for i, r in enumerate(self.replicas):
            cap = self._cap_time[i]
            rec = {
                "capacity": float(r.capacity),
                "alive": float(self.alive[i]),
                "active": float(len(r.active_uids())),
                "est_load": self.load[i],
                "busy_time": self._busy_time[i],
                "bubble_ratio": ((cap - self._busy_time[i]) / cap
                                 if cap > 0 else 0.0),
            }
            sub = getattr(r, "cache_stats", None)
            sub = sub() if sub is not None else None
            if sub:
                rec["stale_kv_reuses"] = sub.get("stale_kv_reuses", 0.0)
                rec["prefill_tokens_saved"] = sub.get(
                    "prefill_tokens_saved", 0.0)
            out.append(MetricsSnapshot(source=f"replica{i}", values=rec))
        return out

    def cache_stats(self) -> MetricsSnapshot:
        """Group gauges + the replicas' paged-KV counters summed, as one
        :class:`MetricsSnapshot` (Mapping-compatible).

        Always non-None (even over SimEngine replicas), so the
        orchestrator's ``record_cache`` plumbing picks the group fields up
        for any replica type."""
        out: Dict[str, float] = {
            "num_replicas": float(len(self.replicas)),
            "alive_replicas": float(sum(self.alive)),
            "steal_count": float(self.steal_count),
            "steal_migrations": float(self.steal_migrations),
            "packed_entries": float(self.packed_entries),
            "replica_deaths": float(self.replica_deaths),
            "rehomed_entries": float(self.rehomed_entries),
            "rerolled_entries": float(self.rerolled_entries),
            "scale_events": float(self.scale_events),
            "residency_dropped": float(self.residency_dropped),
            "replica_busy": self.replica_busy,
            "replica_bubble_ratio": self.replica_bubble_ratio,
            # cumulative Eq. 4 integrals: windowed consumers (the
            # autoscaler's MetricsWindow) difference successive snapshots
            # to get bubble over a recent span rather than the whole run
            "replica_busy_time": float(sum(self._busy_time)),
            "replica_cap_time": float(sum(self._cap_time)),
        }
        subs = []
        for r in self.replicas:
            fn = getattr(r, "cache_stats", None)
            sub = fn() if fn is not None else None
            if sub:
                subs.append(sub)
        if subs:
            for key in ("prefill_tokens_run", "prefill_tokens_saved",
                        "shared_prefills", "resumed_without_prefill",
                        "cow_copies", "evictions", "stale_kv_reuses",
                        "migrated_pages", "pages_in_use", "pages_total",
                        "resident_seqs", "prefill_launches",
                        "resume_attempts", "pool_capacity_tokens"):
                out[key] = float(sum(s.get(key, 0) for s in subs))
            # fleet-level hit rate, recomputed from the summed counters
            # (averaging per-replica rates would weight idle replicas
            # equally with loaded ones)
            out["resident_resume_rate"] = (
                out["resumed_without_prefill"]
                / max(out["resume_attempts"], 1.0))
            # saturation gauge: the WORST per-replica occupancy.  Pooling
            # (sum in_use / sum total) would read ~0.4 while one skewed
            # replica sits at 1.0 evicting resident KV.
            out["page_occupancy"] = max(
                float(s.get("page_occupancy", 0.0)) for s in subs)
        return MetricsSnapshot(source="engine_group", values=out)
