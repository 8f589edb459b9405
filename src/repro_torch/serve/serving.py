"""Always-on serving orchestration: continuous batching with no epoch
boundary over the existing rollout mechanics.

:class:`ServingOrchestrator` subclasses
:class:`~repro_torch.core.orchestrator.RolloutOrchestrator` and reuses its
fill / step / harvest / train machinery verbatim — the only new control
flow is the unbounded :meth:`run_for` loop:

* **admit-as-slots-free** — every iteration pumps the ingress up to the
  current simulated time and runs the normal ``_fill_engine`` path; the
  wrapped :class:`~repro_torch.serve.tenants.ServingPolicy` admits queued
  requests through its admission controller whenever slots would
  otherwise idle;
* **harvest-as-groups-complete** — when the wrapped strategy says
  ``harvest_now`` (and runners exist), stragglers are interrupted and
  scavenged through the shared ``_harvest_stragglers`` path;
* **train-as-threshold-met** — whenever ``update_batch`` trajectories
  are DONE the trainer is fed through the normal ``train_ready`` path;
  consumed entries are pruned immediately (continuous batching never
  calls ``advance_group`` — there is no group to advance), so buffer
  memory stays bounded on an unbounded stream.

Time is simulated throughout.  Over a virtual-clock engine (SimEngine,
or an EngineGroup of them) the serving clock IS the engine clock, plus
the idle gaps the loop skips while waiting for the next arrival.  Real
wall-clock engines (SlotEngine) pass ``tick=<dt>`` instead: the serving
clock then advances by a fixed ``tick`` per decode step, so scheduling
decisions stay deterministic — no wall clock ever reaches them.

Works unchanged over :class:`~repro_torch.rollout.group.EngineGroup` — every
balancer, ``async_step``, ``drain_pack``, and fault plans.  Fault plans
need no horizon: the loop polls ``due(step)`` forever and a plan step
beyond whatever the run reaches simply never fires.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.buffer import EntryState, StatefulRolloutBuffer
from repro_torch.core.engine_api import EngineProtocol
from repro_torch.core.metrics import MetricsSnapshot, RolloutMetrics
from repro_torch.core.orchestrator import (RolloutOrchestrator, SortedRLConfig,
                                     TrainFn, UpdateRequest)
from repro_torch.core.policy import SchedulerPolicy
from repro_torch.serve.tenants import Ingress

# iterations with zero observable progress (no arrivals, tokens, updates,
# or clock movement) before the loop declares itself wedged.  Stall
# faults park replicas for a handful of steps; this is orders of
# magnitude above any legitimate quiet streak.
STAGNATION_LIMIT = 10_000


class ServingOrchestrator(RolloutOrchestrator):
    """Continuous batching forever (or until a time / arrival budget)."""

    def __init__(self, engine: EngineProtocol, buffer: StatefulRolloutBuffer,
                 cfg: SortedRLConfig, policy: SchedulerPolicy,
                 train_fn: TrainFn, ingress: Optional[Ingress] = None,
                 metrics: Optional[RolloutMetrics] = None,
                 tick: Optional[float] = None,
                 autoscaler: Optional[object] = None):
        super().__init__(engine, buffer, cfg, policy, train_fn, metrics,
                         autoscaler=autoscaler)
        self.ingress = ingress if ingress is not None else getattr(
            policy, "ingress", None)
        assert self.ingress is not None, (
            "ServingOrchestrator needs an Ingress — pass ingress= or a "
            "ServingPolicy built with one")
        if self.ingress.metrics is None:
            self.ingress.metrics = self.metrics
        self.tick = tick
        self._tick_now = 0.0
        self._idle_skipped = 0.0

    def snapshot(self) -> MetricsSnapshot:
        """The serving tier's typed observability record — the shared
        rollout gauges tagged ``source="serving"`` with the per-tenant
        records nested as children."""
        return self.metrics.snapshot(source="serving")

    # -- the serving clock -------------------------------------------------

    @property
    def now(self) -> float:
        """Simulated serving time: the engine's virtual clock plus skipped
        idle gaps, or the fixed-tick clock for wall-clock engines."""
        if self.tick is not None:
            return self._tick_now
        return self.engine.clock + self._idle_skipped

    def _advance_to(self, t: float) -> None:
        if self.tick is not None:
            self._tick_now = max(self._tick_now, t)
        else:
            self._idle_skipped += max(0.0, t - self.now)

    def _autoscale_queue_stats(self) -> tuple:
        """Backlog pressure for the queue_depth autoscaler: total queued
        requests, the oldest head wait, and the worst head wait as a
        fraction of its tenant's latency SLO — ages measured on the
        *serving* clock (arrivals live on it), not the engine clock."""
        now = self.now
        backlog, oldest, pressure = 0, 0.0, 0.0
        for name, q in self.ingress.queues.items():
            backlog += len(q)
            head = q.head()
            if head is None:
                continue
            wait = max(0.0, now - head.t_arrival)
            oldest = max(oldest, wait)
            slo = self.ingress.specs[name].latency_slo
            if slo:
                pressure = max(pressure, wait / slo)
        return backlog, oldest, pressure

    # -- the loop ----------------------------------------------------------

    def run_for(self, sim_time: Optional[float] = None,
                n_arrivals: Optional[int] = None) -> RolloutMetrics:
        """Serve until ``sim_time`` simulated seconds have passed and/or
        ``n_arrivals`` further arrival events have been taken, then drain:
        deliver + finish everything admitted, train every leftover, and
        return the metrics.  At least one bound is required — the loop is
        otherwise literally endless."""
        assert sim_time is not None or n_arrivals is not None, \
            "run_for needs a bound: sim_time and/or n_arrivals"
        ing = self.ingress
        if n_arrivals is not None:
            budget = ing.arrival_count + n_arrivals
            ing.max_arrivals = (budget if ing.max_arrivals is None
                                else min(ing.max_arrivals, budget))
        t_stop = self.now + sim_time if sim_time is not None else None
        stagnant = 0
        last_sig = None
        while True:
            if t_stop is not None and self.now >= t_stop and not ing.closed:
                ing.close()
            ing.pump(self.now)
            self._fill_engine()
            if self.engine.active_uids():
                t0 = self.engine.clock
                events = self.engine.step()
                if self.tick is not None:
                    self._tick_now += self.tick
                self._apply_events(events, t0)
                self._maybe_harvest()
                self._train_continuous()
            else:
                self._train_continuous()
                nt = ing.next_arrival_time()
                if nt is not None and (t_stop is None or nt <= t_stop):
                    self._advance_to(nt)     # idle until the next arrival
                elif t_stop is not None and self.now < t_stop:
                    self._advance_to(t_stop)  # idle out the serving window
                elif (ing.drained() and not self.buffer.pending()
                        and not self.buffer.running()):
                    break                    # stream over, engine drained
                elif self.engine.free_slots() <= 0:
                    break                    # fleet dead: nothing can decode
            sig = (ing.arrival_count, len(ing.events),
                   self.metrics.tokens_generated, self.metrics.updates,
                   self.metrics.harvests, len(self.buffer.entries), self.now)
            stagnant = stagnant + 1 if sig == last_sig else 0
            last_sig = sig
            if stagnant >= STAGNATION_LIMIT:
                raise RuntimeError(
                    f"serving loop wedged (no progress for {stagnant} "
                    f"iterations): {sig}")
        self._train_continuous(final=True)
        return self.metrics

    # -- harvest / train (continuous variants) -----------------------------

    def _maybe_harvest(self) -> None:
        if not self.policy.early_termination:
            return
        if not self.buffer.running():
            return        # nothing to interrupt — don't count a harvest
        threshold = min(self.cfg.resolved_threshold(),
                        len(self.buffer.unconsumed()))
        if self.policy.harvest_now(self._view(threshold)):
            self._harvest_stragglers()

    def _train_continuous(self, final: bool = False) -> int:
        if not final and len(self.buffer.done()) < self.cfg.update_batch:
            return 0
        n = self.train_ready(final=final)
        # prune consumed entries in place of advance_group (continuous
        # batching has no epoch): memory stays bounded, group_epoch
        # stays 0, and the buffer's lifecycle invariant holds trivially
        self.buffer.entries = {u: e for u, e in self.buffer.entries.items()
                               if e.state != EntryState.CONSUMED}
        return n

    # -- per-tenant accounting ---------------------------------------------

    def _apply_events(self, events, t0: float) -> None:
        super()._apply_events(events, t0)
        now = self.now
        ing = self.ingress
        for ev in events:
            e = self.buffer.entries.get(ev.uid)
            meta = e.meta if e is not None else None
            tenant = getattr(meta, "tenant", None)
            if tenant is None:
                continue
            st = self.metrics.tenant(tenant)
            st.tokens += 1
            if ev.done:
                st.completed += 1
                t_admit = (meta.t_admit if meta.t_admit is not None
                           else meta.t_arrival)
                st.queue_wait.add(t_admit - meta.t_arrival)
                st.latency.add(now - meta.t_arrival)
                if meta.deadline is not None and now > meta.deadline:
                    st.slo_misses += 1
                ing.record("done", tenant, meta.seq, now)
        # bubble attribution: idle-slot time is charged to the tenants
        # whose queued work COULD have filled those slots (equal split
        # across backlogged tenants); with no backlog the idle time is
        # nobody's fault — there was nothing to run
        # count distinct busy slots, not events: async micro-steps emit
        # >1 event per uid per group step, so len(events) overstates
        # occupancy and clamps idle to 0, under-charging bubble_time
        dt = self.engine.clock - t0
        busy = len({ev.uid for ev in events})
        idle = max(0, self.engine.capacity - busy)
        if idle and dt > 0:
            waiting = [n for n, q in ing.queues.items() if len(q)]
            if waiting:
                share = idle * dt / len(waiting)
                for name in waiting:
                    self.metrics.tenant(name).bubble_time += share

    def _update_request(self, entries, final: bool) -> UpdateRequest:
        for e in entries:
            tenant = getattr(e.meta, "tenant", None)
            if tenant is not None:
                self.metrics.tenant(tenant).consumed += 1
        return super()._update_request(entries, final)


__all__ = ["ServingOrchestrator", "STAGNATION_LIMIT"]
