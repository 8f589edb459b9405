"""Multi-tenant ingress: tenant specs, bounded per-tenant queues, and the
admission-controller registry for the always-on serving tier.

A :class:`TenantSpec` declares a tenant's contract — arrival weight,
optional rate limit (token bucket), optional latency SLO, queue bound.
Arrivals land in per-tenant bounded :class:`TenantQueue`\\ s inside an
:class:`Ingress`; requests the bucket or the bound rejects are *shed*
(counted per tenant, logged).  An **admission policy** then decides which
queued requests enter the rollout buffer whenever the engine has spare
slots:

* ``fifo``          — global arrival order, tenant-blind (the baseline);
* ``weighted_fair`` — deficit round robin across tenants: each visit
  banks ``quantum * weight`` credit, admissions spend it, so long-run
  admission shares converge to the weight ratio and no backlogged tenant
  starves (the guarantee ``serving_conformance`` pins);
* ``slo_aware``     — earliest deadline first over the queue heads
  (deadline = arrival + the tenant's ``latency_slo``; no SLO = never
  urgent), which is what keeps a latency-sensitive tenant's p99 down
  while a batch tenant floods the queue.

Admission composes with — it does not replace — the scheduling policy:
:class:`ServingPolicy` wraps ANY registered
:class:`~repro_torch.core.policy.SchedulerPolicy` (``DelegatingPolicy``) and
overrides only ``admit_next_group``, so fill order, harvesting, and
training order stay whatever the wrapped strategy says.  It is itself
registered as ``"serving"``.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.policy import (AdmitRequest, DelegatingPolicy, SchedView,
                               SchedulerPolicy, make_policy, register_policy)

# -----------------------------------------------------------------------------
# tenant specs
# -----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's service contract."""
    name: str
    weight: float = 1.0               # weighted_fair admission share
    rate_limit: Optional[float] = None   # req/s token bucket (None = open)
    burst: Optional[float] = None     # bucket depth (default max(1, rate))
    latency_slo: Optional[float] = None  # e2e deadline, arrival-relative
    queue_capacity: int = 64          # bounded queue; overflow is shed
    group_size: int = 1               # requests per arrival (GRPO group)

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.queue_capacity < 1:
            raise ValueError(
                f"tenant {self.name!r}: queue_capacity must be >= 1")

    @property
    def bucket_depth(self) -> float:
        if self.burst is not None:
            return float(self.burst)
        return max(1.0, float(self.rate_limit or 1.0))


def coerce_specs(specs: Sequence) -> List[TenantSpec]:
    """Accept TenantSpec instances or plain dicts (the
    ``SessionConfig.tenants`` wire format)."""
    out = []
    for s in specs:
        if not isinstance(s, TenantSpec):
            s = TenantSpec(**s)
        out.append(s)
    names = [s.name for s in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    return out


@dataclasses.dataclass
class ServeMeta:
    """Entry meta carried through the rollout buffer for serving
    requests.  ``payload`` holds the caller's opaque task data (e.g. the
    verifier ground truth) — reward plumbing unwraps it via
    ``getattr(meta, "payload", meta)``."""
    tenant: str
    seq: int                       # ingress-global request id
    t_arrival: float
    t_admit: Optional[float] = None
    deadline: Optional[float] = None
    length_hint: Optional[int] = None
    payload: Any = None
    prompt_id: Optional[int] = None   # arrival group id (GRPO grouping)


@dataclasses.dataclass
class QueuedRequest:
    """One request waiting in a tenant queue."""
    seq: int
    tenant: str
    prompt: List[int]
    t_arrival: float
    deadline: Optional[float] = None
    length_hint: Optional[int] = None
    payload: Any = None
    group_id: int = 0              # arrival index (group_size expansion)

    def sort_deadline(self) -> float:
        return self.deadline if self.deadline is not None else float("inf")


class TenantQueue:
    """Bounded FIFO with an optional token-bucket rate limit.  Both
    rejections (bucket empty, queue full) shed the request — the caller
    records which tenant shed what."""

    def __init__(self, spec: TenantSpec):
        self.spec = spec
        self._q: collections.deque = collections.deque()
        self.depth_peak = 0
        self.admitted = 0
        self._tokens = spec.bucket_depth
        self._bucket_t = 0.0

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, req: QueuedRequest, now: float) -> bool:
        spec = self.spec
        if spec.rate_limit is not None:
            self._tokens = min(spec.bucket_depth,
                               self._tokens
                               + (now - self._bucket_t) * spec.rate_limit)
            self._bucket_t = now
            if self._tokens < 1.0:
                return False
        if len(self._q) >= spec.queue_capacity:
            return False
        if spec.rate_limit is not None:
            self._tokens -= 1.0
        self._q.append(req)
        self.depth_peak = max(self.depth_peak, len(self._q))
        return True

    def head(self) -> Optional[QueuedRequest]:
        return self._q[0] if self._q else None

    def pop(self) -> QueuedRequest:
        return self._q.popleft()


# -----------------------------------------------------------------------------
# admission registry
# -----------------------------------------------------------------------------

# an admission policy pops up to `budget` requests from the queues;
# whatever it returns is admitted into the rollout buffer
AdmissionPolicy = Callable  # select(queues, budget, now) -> List[QueuedRequest]

_ADMISSIONS: Dict[str, Callable[..., AdmissionPolicy]] = {}


def register_admission(name: str):
    def deco(factory):
        _ADMISSIONS[name] = factory
        return factory
    return deco


def make_admission(name: str, **kwargs) -> AdmissionPolicy:
    if name not in _ADMISSIONS:
        raise KeyError(f"unknown admission policy {name!r}; "
                       f"registered: {available_admissions()}")
    return _ADMISSIONS[name](**kwargs)


def available_admissions() -> List[str]:
    return sorted(_ADMISSIONS)


@register_admission("fifo")
class FifoAdmission:
    """Global arrival order, tenant-blind: repeatedly admit the earliest
    queue head.  The baseline every other policy is measured against."""

    name = "fifo"

    def select(self, queues: Dict[str, TenantQueue], budget: int,
               now: float) -> List[QueuedRequest]:
        picked: List[QueuedRequest] = []
        while budget > 0:
            heads = [(q.head().t_arrival, q.head().seq, name)
                     for name, q in queues.items() if len(q)]
            if not heads:
                break
            _, _, name = min(heads)
            picked.append(queues[name].pop())
            budget -= 1
        return picked


@register_admission("weighted_fair")
class WeightedFairAdmission:
    """Deficit round robin across tenants.  Each visit to a backlogged
    tenant banks ``quantum * weight`` credit; admitting one request
    spends 1.  Credit resets when a tenant's queue empties (no banking
    unbounded priority while idle), and the rotation pointer advances
    every call, so with any positive weight a backlogged tenant is
    admitted within a bounded number of calls — the no-starvation
    guarantee — while long-run shares converge to the weight ratio."""

    name = "weighted_fair"

    def __init__(self, quantum: float = 1.0):
        assert quantum > 0
        self.quantum = quantum
        self.deficits: Dict[str, float] = {}
        self._ptr = 0

    def select(self, queues: Dict[str, TenantQueue], budget: int,
               now: float) -> List[QueuedRequest]:
        picked: List[QueuedRequest] = []
        names = list(queues)
        if not names or budget <= 0:
            return picked
        self._ptr %= len(names)
        while budget > 0 and any(len(q) for q in queues.values()):
            for k in range(len(names)):
                name = names[(self._ptr + k) % len(names)]
                q = queues[name]
                if not len(q):
                    self.deficits[name] = 0.0
                    continue
                self.deficits[name] = (self.deficits.get(name, 0.0)
                                       + self.quantum * q.spec.weight)
                while len(q) and budget > 0 and self.deficits[name] >= 1.0:
                    picked.append(q.pop())
                    self.deficits[name] -= 1.0
                    budget -= 1
                if not len(q):
                    self.deficits[name] = 0.0
                if budget <= 0:
                    break
        self._ptr = (self._ptr + 1) % len(names)
        return picked


@register_admission("slo_aware")
class SloAwareAdmission:
    """Earliest deadline first over the queue heads.  A tenant's deadline
    is ``t_arrival + latency_slo``, constant per tenant, so each queue's
    head carries its earliest deadline and head-EDF is exact EDF over
    all queued requests.  Tenants without an SLO sort last (deadline
    +inf) — they are served from the slack the urgent tenants leave."""

    name = "slo_aware"

    def select(self, queues: Dict[str, TenantQueue], budget: int,
               now: float) -> List[QueuedRequest]:
        picked: List[QueuedRequest] = []
        while budget > 0:
            heads = [(q.head().sort_deadline(), q.head().t_arrival,
                      q.head().seq, name)
                     for name, q in queues.items() if len(q)]
            if not heads:
                break
            name = min(heads)[-1]
            picked.append(queues[name].pop())
            budget -= 1
        return picked


# -----------------------------------------------------------------------------
# ingress
# -----------------------------------------------------------------------------


class Ingress:
    """Streaming front door: pulls arrivals from a seeded process, shapes
    them through per-tenant bounded queues, and keeps the authoritative
    per-tenant event log ``(t, kind, tenant, seq)`` with kinds ``arrive``
    / ``shed`` / ``admit`` / ``done`` — the determinism regression
    compares two same-seed runs' full logs.

    All time comes from the caller (``pump(now)``) on the simulated
    clock; the ingress never reads a wall clock."""

    def __init__(self, specs: Sequence, arrivals,
                 max_arrivals: Optional[int] = None, metrics=None):
        specs = coerce_specs(specs)
        self.specs: Dict[str, TenantSpec] = {s.name: s for s in specs}
        self.queues: Dict[str, TenantQueue] = {
            s.name: TenantQueue(s) for s in specs}
        self._it = iter(arrivals)
        self._next = None
        self._exhausted = False
        self.max_arrivals = max_arrivals
        self.arrival_count = 0        # arrival EVENTS delivered (pre-expansion)
        self.closed = False
        self.now = 0.0
        self.events: List[tuple] = []
        self._seq = itertools.count()
        self.metrics = metrics        # RolloutMetrics (set by the orchestrator)

    # -- stream ------------------------------------------------------------

    def _peek(self):
        if (self._next is None and not self.closed and not self._exhausted
                and (self.max_arrivals is None
                     or self.arrival_count < self.max_arrivals)):
            self._next = next(self._it, None)
            if self._next is None:
                self._exhausted = True
        return self._next

    def next_arrival_time(self) -> Optional[float]:
        a = self._peek()
        return a.t if a is not None else None

    def close(self) -> None:
        """Stop accepting arrivals; a pending lookahead event is dropped
        (deterministically — it is beyond the serving window)."""
        self.closed = True
        self._next = None

    def pump(self, now: float) -> int:
        """Deliver every arrival with ``t <= now``; returns how many
        arrival events were delivered."""
        self.now = max(self.now, now)
        n = 0
        while True:
            a = self._peek()
            if a is None or a.t > self.now:
                break
            self._next = None
            self.arrival_count += 1
            n += 1
            self._deliver(a)
        return n

    def _deliver(self, a) -> None:
        if a.tenant not in self.queues:
            raise KeyError(f"arrival for unknown tenant {a.tenant!r}; "
                           f"declared: {sorted(self.queues)}")
        q = self.queues[a.tenant]
        slo = self.specs[a.tenant].latency_slo
        gid = self.arrival_count - 1
        for _ in range(max(1, a.group_size)):
            seq = next(self._seq)
            req = QueuedRequest(
                seq=seq, tenant=a.tenant, prompt=list(a.prompt),
                t_arrival=a.t,
                deadline=(a.t + slo) if slo is not None else None,
                length_hint=a.length_hint, payload=a.payload, group_id=gid)
            self.record("arrive", a.tenant, seq, a.t)
            st = self._stat(a.tenant)
            if st is not None:
                st.arrivals += 1
            if not q.offer(req, a.t):
                self.record("shed", a.tenant, seq, a.t)
                if st is not None:
                    st.shed += 1

    # -- accounting --------------------------------------------------------

    def _stat(self, tenant: str):
        return self.metrics.tenant(tenant) if self.metrics is not None else None

    def note_admit(self, req: QueuedRequest, now: float) -> None:
        self.queues[req.tenant].admitted += 1
        st = self._stat(req.tenant)
        if st is not None:
            st.admitted += 1
        self.record("admit", req.tenant, req.seq, now)

    def record(self, kind: str, tenant: str, seq: int, t: float) -> None:
        self.events.append((round(t, 9), kind, tenant, seq))

    # -- queries -----------------------------------------------------------

    def queued_total(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def drained(self) -> bool:
        """No future arrivals (closed / exhausted / budget spent) and
        nothing left queued."""
        return self._peek() is None and self.queued_total() == 0


# -----------------------------------------------------------------------------
# the SchedulerPolicy extension point
# -----------------------------------------------------------------------------


@register_policy("serving")
class ServingPolicy(DelegatingPolicy):
    """Admission-controlled serving over ANY scheduling strategy.

    Wraps a registered policy (``inner``, by name or instance) and
    overrides only ``admit_next_group``: whenever the engine has slots no
    pending entry will take, the admission policy picks which tenants'
    queued requests enter the buffer.  Everything else — fill order,
    harvest timing, training order, update gating — delegates to the
    wrapped strategy, so every (admission x scheduler) pair composes.

    Without an ingress the policy is a transparent proxy for ``inner``
    (this is what the no-args registry contract exercises); with one,
    the strict group barrier is dropped — continuous batching has no
    epoch boundary.
    """

    name = "serving"

    def __init__(self, inner: "str | SchedulerPolicy" = "sorted",
                 admission: "str | AdmissionPolicy" = "fifo",
                 ingress: Optional[Ingress] = None,
                 inner_kwargs: Optional[dict] = None,
                 admission_kwargs: Optional[dict] = None):
        if isinstance(inner, str):
            inner = make_policy(inner, **(inner_kwargs or {}))
        super().__init__(inner)
        if isinstance(admission, str):
            admission = make_admission(admission, **(admission_kwargs or {}))
        self.admission = admission
        self.ingress = ingress
        if ingress is not None:
            self.strict_group_barrier = False

    def admit_next_group(self, view: SchedView) -> Optional[AdmitRequest]:
        ing = self.ingress
        if ing is None:
            return self.inner.admit_next_group(view)
        # only admit what pending work will not already absorb: the
        # buffer's pending set is bounded by the engine's capacity
        budget = view.free_slots - view.pending
        if budget <= 0:
            return None
        picked = self.admission.select(ing.queues, budget, ing.now)
        if not picked:
            return None
        prompts, metas = [], []
        for req in picked:
            meta = ServeMeta(
                tenant=req.tenant, seq=req.seq, t_arrival=req.t_arrival,
                t_admit=ing.now, deadline=req.deadline,
                length_hint=req.length_hint, payload=req.payload,
                prompt_id=req.group_id)
            ing.note_admit(req, ing.now)
            prompts.append(req.prompt)
            metas.append(meta)
        return AdmitRequest(prompts, metas)
