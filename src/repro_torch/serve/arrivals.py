"""Deterministic, seeded arrival processes for the always-on serving tier.

Each process is an iterable of :class:`Arrival` events — ``(t, tenant,
prompt, group_size, length_hint)`` — ordered by arrival time on the
SIMULATED clock.  All randomness comes from string-seeded
``random.Random`` instances (one per tenant, independent of each other
and of prompt sampling), so the same seed produces the same event stream
on every platform and process: the serving loop's determinism regression
compares two same-seed runs' full per-tenant event logs.

Three shapes:

* :class:`PoissonArrivals` — per-tenant independent Poisson streams
  (exponential inter-arrival gaps at each tenant's rate), merged by time;
* :class:`BurstyArrivals` — on/off (interrupted Poisson) per tenant:
  bursts of ``on_time`` at ``rate``, silent for ``off_time``, with a
  seeded per-tenant phase offset so tenants don't burst in lockstep;
* :class:`TraceArrivals` — replay of a recorded workload, so two
  admission policies can be compared on the IDENTICAL arrival sequence
  (the ``bursty_slo`` benchmark pins slo_aware vs fifo this way).

``record_trace(process, n)`` materialises the first ``n`` events of any
process into the tuple form ``TraceArrivals`` accepts.
"""
from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request-group arrival at the ingress."""
    t: float                       # arrival time (simulated clock)
    tenant: str
    prompt: List[int]
    group_size: int = 1            # expanded into this many requests
    length_hint: Optional[int] = None   # expected generation length
    payload: Any = None            # opaque task data (e.g. verifier truth)


# prompt_sampler(rng, tenant) -> prompt | (prompt, payload)
PromptSampler = Callable[[random.Random, str], Any]


def default_prompt_sampler(rng: random.Random, tenant: str) -> List[int]:
    """Token-id filler with a varied length — enough for the simulator,
    where only prompt length matters.  Real runs pass their own sampler
    (tokenised tasks, verifier payloads)."""
    return [1] * rng.randint(4, 12)


def _sample_prompt(sampler: PromptSampler, rng: random.Random, tenant: str):
    out = sampler(rng, tenant)
    if isinstance(out, tuple) and len(out) == 2:
        return list(out[0]), out[1]
    return list(out), None


class _MergedProcess:
    """Shared shape: per-tenant generators merged by (t, tenant)."""

    def __init__(self, rates: Dict[str, float], seed: int = 0,
                 prompt_sampler: Optional[PromptSampler] = None,
                 group_size: "int | Dict[str, int]" = 1,
                 length_hint: Optional[Callable[[random.Random, str],
                                                int]] = None):
        assert rates, "need at least one tenant"
        for name, rate in rates.items():
            assert rate > 0, f"tenant {name!r}: rate must be > 0"
        self.rates = dict(rates)
        self.seed = seed
        self.prompt_sampler = prompt_sampler or default_prompt_sampler
        self.group_size = group_size
        self.length_hint = length_hint

    def _group(self, tenant: str) -> int:
        if isinstance(self.group_size, dict):
            return int(self.group_size.get(tenant, 1))
        return int(self.group_size)

    def _tenant_stream(self, tenant: str) -> Iterator[Arrival]:
        raise NotImplementedError

    def _emit(self, tenant: str, t: float, gap_rng: random.Random,
              prompt_rng: random.Random) -> Arrival:
        prompt, payload = _sample_prompt(self.prompt_sampler,
                                         prompt_rng, tenant)
        hint = (self.length_hint(gap_rng, tenant)
                if self.length_hint is not None else None)
        return Arrival(t=t, tenant=tenant, prompt=prompt,
                       group_size=self._group(tenant),
                       length_hint=hint, payload=payload)

    def __iter__(self) -> Iterator[Arrival]:
        streams = [self._tenant_stream(name)
                   for name in sorted(self.rates)]
        return heapq.merge(*streams, key=lambda a: (a.t, a.tenant))


class PoissonArrivals(_MergedProcess):
    """Independent Poisson stream per tenant, merged by time."""

    KIND = "poisson"

    def _tenant_stream(self, tenant: str) -> Iterator[Arrival]:
        gap_rng = random.Random(f"{self.KIND}:{self.seed}:{tenant}")
        prompt_rng = random.Random(f"prompt:{self.seed}:{tenant}")
        rate = self.rates[tenant]
        t = 0.0
        while True:
            t += gap_rng.expovariate(rate)
            yield self._emit(tenant, t, gap_rng, prompt_rng)


class BurstyArrivals(_MergedProcess):
    """Interrupted Poisson per tenant: arrivals at ``rate`` during
    ``on_time`` windows, silence for ``off_time``, repeating.  Each
    tenant gets a seeded phase offset inside the cycle so the fleet sees
    staggered (not synchronised) bursts — the workload the slo_aware
    admission policy exists for."""

    KIND = "bursty"

    def __init__(self, rates: Dict[str, float], seed: int = 0,
                 prompt_sampler: Optional[PromptSampler] = None,
                 group_size: "int | Dict[str, int]" = 1,
                 length_hint=None,
                 on_time: float = 1.0, off_time: float = 3.0):
        super().__init__(rates, seed, prompt_sampler, group_size,
                         length_hint)
        assert on_time > 0 and off_time >= 0
        self.on_time = on_time
        self.off_time = off_time

    def _tenant_stream(self, tenant: str) -> Iterator[Arrival]:
        gap_rng = random.Random(f"{self.KIND}:{self.seed}:{tenant}")
        prompt_rng = random.Random(f"prompt:{self.seed}:{tenant}")
        rate = self.rates[tenant]
        cycle = self.on_time + self.off_time
        t = gap_rng.uniform(0.0, cycle)          # per-tenant phase offset
        while True:
            t += gap_rng.expovariate(rate)
            # arrivals only inside on-windows: a draw landing in the off
            # part of the cycle is deferred to the next window's start
            into = t % cycle
            if into >= self.on_time:
                t += cycle - into
            yield self._emit(tenant, t, gap_rng, prompt_rng)


class TraceArrivals:
    """Replay a recorded workload verbatim.  Accepts :class:`Arrival`
    objects or plain tuples ``(t, tenant, prompt[, group_size[,
    length_hint[, payload]]])`` (the ``record_trace`` wire format)."""

    def __init__(self, trace: Sequence):
        events: List[Arrival] = []
        for item in trace:
            if not isinstance(item, Arrival):
                t, tenant, prompt = item[0], item[1], item[2]
                group = item[3] if len(item) > 3 else 1
                hint = item[4] if len(item) > 4 else None
                payload = item[5] if len(item) > 5 else None
                item = Arrival(t=float(t), tenant=tenant,
                               prompt=list(prompt), group_size=int(group),
                               length_hint=hint, payload=payload)
            events.append(item)
        self.events = sorted(events, key=lambda a: (a.t, a.tenant))

    def __iter__(self) -> Iterator[Arrival]:
        return iter(self.events)


def record_trace(process, n: int) -> List[tuple]:
    """Materialise the first ``n`` arrivals of a process as replayable
    tuples (so distinct admission policies can be benchmarked against the
    IDENTICAL seeded arrival sequence)."""
    out = []
    for arr in process:
        if len(out) >= n:
            break
        out.append((arr.t, arr.tenant, list(arr.prompt), arr.group_size,
                    arr.length_hint, arr.payload))
    return out


# declarative construction (SessionConfig.arrival wire format)
ARRIVAL_KINDS = {"poisson": PoissonArrivals, "bursty": BurstyArrivals}


def make_arrivals(spec: "dict | TraceArrivals | _MergedProcess"):
    """Build an arrival process from a config dict:
    ``{"kind": "poisson", "rates": {...}, "seed": 0, ...}`` or
    ``{"kind": "trace", "trace": [...]}``.  Already-built processes pass
    through unchanged."""
    if not isinstance(spec, dict):
        return spec
    spec = dict(spec)
    kind = spec.pop("kind", "poisson")
    if kind == "trace":
        return TraceArrivals(spec["trace"])
    if kind not in ARRIVAL_KINDS:
        raise KeyError(f"unknown arrival kind {kind!r}; expected one of "
                       f"{sorted(ARRIVAL_KINDS) + ['trace']}")
    return ARRIVAL_KINDS[kind](**spec)
