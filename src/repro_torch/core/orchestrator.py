"""Rollout orchestration mechanics (paper §3.1 Fig. 2a), policy-agnostic.

One :class:`RolloutOrchestrator` owns everything the old controller family
re-implemented four times: engine feeding (oversubscription), decode-event
plumbing, early termination + scavenging, utilisation metrics, trainer
hand-off, weight sync, and group advancement.  Strategy differences live
entirely in a :class:`~repro_torch.core.policy.SchedulerPolicy`:

    policy = make_policy("sorted")
    orch = RolloutOrchestrator(engine, buffer, cfg, policy, train_fn)
    orch.run_group(prompts, metas)

The trainer hand-off is typed: the orchestrator talks to a
:class:`~repro_torch.rl.trainer_api.Trainer` (``submit`` / ``poll`` / ``flush``)
carrying :class:`UpdateRequest` batches (entries, trainer version, group
epoch, per-batch staleness stats) and collecting :class:`UpdateResult`
outcomes.  A bare ``TrainFn`` callable is still accepted everywhere — the
:func:`~repro_torch.rl.trainer_api.as_trainer` shim wraps it in a zero-cost
synchronous trainer (deprecated path; new call sites should pass a
trainer built by ``make_trainer``).  Before each hand-off the policy's
``update_gate`` may veto the batch (PipelineRL-style staleness cap);
vetoed batches are consumed but not trained.

With ``cfg.overlap_updates`` and a trainer whose ``supports_overlap`` is
True (``make_trainer("streaming")``), submitted update batches charge
their modeled trainer time *concurrently* with continued rollout: the
weight sync lands in-flight mid-rollout when ``poll`` observes the
modeled completion time passing, and only un-overlapped trainer time
stalls the rollout clock (``metrics.update_overlap_frac`` reports the
overlapped share).  Mode semantics are preserved per entry: partial mode
keeps decoding through the sync (the per-token version stamps build the
stitched pi_old), while on-policy mode invalidates every in-flight entry
at the sync point — exactly the retain-vs-invalidate rule the
version-stamped KV machinery applies.

Entry points mirror the strategies' driving patterns:

  * ``run_group(prompts)``   — strict grouped loading (sorted / baseline /
    posthoc_sort / length_binned);
  * ``run_steps(n_updates)`` — barrier-free streaming (ungrouped);
  * ``run_queued()``         — relaxed barrier over queued groups
    (pipelined lookahead).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.buffer import (BufferEntry, EntryState, Mode,
                               StatefulRolloutBuffer)
from repro_torch.core.engine_api import EngineProtocol, StepEvent
from repro_torch.core.metrics import MetricsSnapshot, RolloutMetrics
from repro_torch.core.policy import SchedulerPolicy, SchedView


@dataclasses.dataclass
class SortedRLConfig:
    """Shared scheduling knobs (formerly on the controller family)."""
    mode: Mode = Mode.ON_POLICY
    rollout_batch: int = 128          # b — prompts loaded per batch
    group_size: int = 4               # n — batches per group (n*b prompts)
    update_batch: int = 128           # trajectories per trainer update
    max_gen_len: int = 4096
    # harvest when this many trajectories are ready.  None (default)
    # resolves to update_batch; an explicit 0 means "harvest after every
    # decode step" (maximum scavenging pressure — sensible only with
    # Mode.PARTIAL, where progress survives the interrupt; an on-policy
    # re-roll would discard its single new token forever).
    harvest_threshold: Optional[int] = None
    # train on leftover (< update_batch) trajectories at group end
    train_leftover: bool = True
    # engine replicas behind the orchestrator (EngineGroup when > 1);
    # consumed by session/benchmark builders — the orchestrator itself
    # only ever sees the merged EngineProtocol surface
    num_replicas: int = 1
    # EngineGroup tail knobs (ignored when num_replicas == 1): drop the
    # lockstep step barrier / consolidate the drain-phase tail onto the
    # fewest replicas via cross-replica KV migration
    async_step: bool = False
    drain_pack: bool = False
    # rollout/update overlap: update batches run on the trainer timeline
    # concurrently with continued rollout and the weight sync lands
    # mid-rollout; requires a Trainer with supports_overlap (streaming)
    overlap_updates: bool = False

    def __post_init__(self):
        if self.harvest_threshold is not None and self.harvest_threshold < 0:
            raise ValueError(
                f"harvest_threshold must be >= 0 or None, "
                f"got {self.harvest_threshold}")
        if self.harvest_threshold == 0 and Mode(self.mode) == Mode.ON_POLICY:
            # livelock: every step would interrupt all entries and the
            # on-policy scavenge discards their single new token, so no
            # prompt needing >1 token can ever finish
            raise ValueError(
                "harvest_threshold=0 requires Mode.PARTIAL (on-policy "
                "scavenging would discard every step's progress forever)")

    def resolved_threshold(self) -> int:
        # NOT `or`: an explicit harvest_threshold=0 must stay 0 instead of
        # silently coercing to update_batch
        if self.harvest_threshold is None:
            return self.update_batch
        return self.harvest_threshold


@dataclasses.dataclass
class UpdateRequest:
    """One update batch handed to the trainer."""
    entries: List[BufferEntry]
    version: int              # trainer policy version producing this update
    group_epoch: int
    final: bool               # leftover batch at group end
    staleness_mean: float     # mean per-entry staleness vs `version`
    staleness_max: float


@dataclasses.dataclass
class UpdateResult:
    """Trainer feedback for one update (losses, rewards, ...)."""
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)


# DEPRECATED hand-off shape: kept as the shim target for existing call
# sites — as_trainer wraps any such callable in a zero-cost SyncTrainer.
# New code should pass a Trainer (repro_torch.rl.trainer_api.make_trainer).
TrainFn = Callable[[UpdateRequest], Optional[UpdateResult]]


class RolloutOrchestrator:
    """Drives any EngineProtocol + StatefulRolloutBuffer under a policy."""

    def __init__(self, engine: EngineProtocol, buffer: StatefulRolloutBuffer,
                 cfg: SortedRLConfig, policy: SchedulerPolicy,
                 train_fn: "TrainFn | object",
                 metrics: Optional[RolloutMetrics] = None,
                 autoscaler: Optional[object] = None):
        from repro_torch.rl.trainer_api import as_trainer
        self.engine = engine
        self.buffer = buffer
        self.cfg = cfg
        self.policy = policy
        # bare callables ride through the deprecated-path shim; Trainer
        # instances pass through untouched
        self.train_fn = train_fn
        self.trainer = as_trainer(train_fn)
        self._overlap = bool(cfg.overlap_updates)
        if self._overlap and not self.trainer.supports_overlap:
            raise ValueError(
                f"overlap_updates=True needs a trainer with "
                f"supports_overlap (e.g. make_trainer('streaming')); "
                f"got {getattr(self.trainer, 'name', type(train_fn))!r}")
        self.version = 0
        self.metrics = metrics or RolloutMetrics(capacity=engine.capacity)
        self.update_results: List[UpdateResult] = []
        # rollout-clock stalls charged for un-overlapped trainer time —
        # self._now() (engine clock + stalls) is the shared timeline the
        # trainer's modeled compute is scheduled on
        self._stall_total = 0.0
        # skip the per-step view build when the policy never admits
        from repro_torch.core.policy import BasePolicy
        self._policy_admits = (getattr(type(policy), "admit_next_group", None)
                               is not BasePolicy.admit_next_group)
        # paged engines expose page-pool gauges (occupancy, prefill saved)
        self._cache_stats = getattr(engine, "cache_stats", None)
        # fault-tolerant groups surface uids whose replica died without a
        # survivor able to take them; the orchestrator re-rolls those
        self._take_failed = getattr(engine, "take_failed_uids", None)
        # feedback-driven fleet control (repro_torch.rollout.autoscaler): the
        # controller is ticked once per engine step, observing windowed
        # group metrics and driving scale_down/scale_up itself
        self.autoscaler = autoscaler
        if autoscaler is not None:
            if not (hasattr(engine, "scale_down")
                    and getattr(engine, "elastic", False)):
                raise ValueError(
                    "autoscaler requires an elastic EngineGroup "
                    "(EngineGroup(..., elastic=True)) as the engine")

    def snapshot(self) -> MetricsSnapshot:
        """The run's typed observability record (see MetricsSnapshot)."""
        return self.metrics.snapshot()

    # -- scheduling snapshot -------------------------------------------------

    def _view(self, harvest_threshold: int = 0) -> SchedView:
        # single pass over the buffer: state counts, current-epoch
        # variants, and the lookahead budget all come from one scan (this
        # runs every decode step)
        p = r = d = d_cur = u_cur = 0
        load_ok = True
        epoch = self.buffer.group_epoch
        for e in self.buffer.entries.values():
            s = e.state
            if s == EntryState.PENDING:
                p += 1
            elif s == EntryState.RUNNING:
                r += 1
            elif s == EntryState.DONE:
                d += 1
                if e.lifecycle <= epoch:
                    d_cur += 1
            else:
                continue
            if e.lifecycle <= epoch:
                u_cur += 1
            elif e.lifecycle > epoch + 1:
                load_ok = False
        return SchedView(
            pending=p, running=r, done=d, unconsumed=p + r + d,
            free_slots=self.engine.free_slots(),
            capacity=self.engine.capacity,
            group_epoch=epoch,
            version=self.version,
            update_batch=self.cfg.update_batch,
            harvest_threshold=harvest_threshold,
            next_epoch_load_allowed=load_ok,
            done_current=d_cur, unconsumed_current=u_cur)

    # -- engine feeding ------------------------------------------------------

    def _admit(self) -> None:
        if not self._policy_admits:
            return
        req = self.policy.admit_next_group(self._view())
        if req is None or not req.prompts:
            return
        if req.next_epoch:
            self.buffer.load_prompts_next_group(req.prompts, req.metas)
        else:
            self.buffer.load_prompts(req.prompts, req.metas)

    def _fill_engine(self) -> None:
        self._admit()
        free = self.engine.free_slots()
        if free <= 0:
            return
        batch = self.policy.select_fill(self.buffer.pending(), free)
        if not batch:
            return
        self.buffer.mark_running([e.uid for e in batch])
        self.engine.submit(batch, self.version)
        self.metrics.prompts_prefilled += len(batch)

    # -- event plumbing ------------------------------------------------------

    def _apply_events(self, events: Sequence[StepEvent], t0: float) -> None:
        for ev in events:
            self.buffer.record_tokens(ev.uid, [ev.token], [ev.logprob],
                                      self.version)
            if ev.done:
                self.buffer.mark_done(ev.uid, ev.finish_reason or "eos")
        dt = self.engine.clock - t0
        self.metrics.record(len(events), dt, new_tokens=len(events))
        if self._cache_stats is not None:
            self.metrics.record_cache(self._cache_stats())
        # autoscale BEFORE the re-roll drain: a scale_down that re-rolls
        # entries parks their uids in the group's failed list, and the
        # drain below scavenges them back to PENDING in the same step
        self._autoscale_tick()
        if self._take_failed is not None:
            self._reroll_failed()
        if self._overlap:
            # in-flight weight sync: completed updates land mid-rollout
            self._drain_trainer(flush=False)

    def _autoscale_queue_stats(self) -> tuple:
        """(queue_backlog, oldest_wait, slo_pressure) — backlog pressure
        for the autoscaler's serving signals.  The base orchestrator has
        no ingress, so there is never a backlog; ServingOrchestrator
        overrides this with per-tenant head ages vs SLO deadlines."""
        return 0, 0.0, 0.0

    def _autoscale_tick(self) -> None:
        asc = self.autoscaler
        if asc is None:
            return
        backlog, oldest, pressure = self._autoscale_queue_stats()
        asc.tick(self.engine,
                 pending=len(self.buffer.pending()),
                 running=len(self.buffer.running()),
                 queue_backlog=backlog, oldest_wait=oldest,
                 slo_pressure=pressure)

    def _reroll_failed(self) -> None:
        """Entries whose replica died without re-homing: their engine-side
        state is gone, so scavenge them back to PENDING — the next fill
        re-rolls them under the *current* policy version.  The buffer's
        mode decides what survives (on-policy discards their tokens,
        partial keeps them), exactly the early-termination rule, so group
        lifecycle barriers are untouched."""
        for uid in self._take_failed():
            e = self.buffer.entries[uid]
            if self.buffer.mode == Mode.ON_POLICY:
                self.metrics.tokens_discarded += e.gen_len
            self.buffer.scavenge(uid)

    # -- one rollout iteration: decode until harvest -------------------------

    def _harvest_stragglers(self) -> List[int]:
        """Early-terminate every in-flight straggler and scavenge it back
        to PENDING (on-policy discards its tokens, partial keeps them).
        Shared by the epoch harvest below and the serving tier's
        continuous-batching harvest.  Returns the interrupted uids."""
        interrupted = self.engine.interrupt()
        for uid in interrupted:
            e = self.buffer.entries[uid]
            if self.buffer.mode == Mode.ON_POLICY:
                self.metrics.tokens_discarded += e.gen_len
            self.buffer.scavenge(uid)
        self.metrics.harvests += 1
        return interrupted

    def rollout_until_harvest(self) -> None:
        while True:
            # recomputed every iteration: admitting policies (pipelined
            # lookahead, serving ingress) grow the unconsumed set
            # mid-loop, and a threshold frozen at entry would hand
            # harvest_now a stale cap for the rest of the epoch
            threshold = min(self.cfg.resolved_threshold(),
                            len(self.buffer.unconsumed()))
            self._fill_engine()
            if not self.engine.active_uids():
                break
            t0 = self.engine.clock
            events = self.engine.step()
            self._apply_events(events, t0)
            if self.policy.harvest_now(self._view(threshold)):
                break
        if not self.policy.early_termination:
            return   # wait-for-all: the loop above drained the engine
        # early termination of stragglers (both modes; on-policy discards)
        self._harvest_stragglers()

    # -- training ------------------------------------------------------------

    def _now(self) -> float:
        """The rollout timeline trainer compute is scheduled against:
        engine clock plus every stall already charged for un-overlapped
        trainer time (wall-clock engines just ride their own clock)."""
        return self.engine.clock + self._stall_total

    def train_ready(self, final: bool = False) -> int:
        """Order DONE trajectories per the policy and submit them to the
        trainer in update_batch batches.  Without overlap every submission
        completes (and stalls) inline — the classical serialized hand-off;
        with overlap submissions queue on the trainer timeline and land
        via ``poll`` during subsequent rollout steps.  Returns the number
        of updates completed during this call."""
        ready = self.policy.order_ready(self.buffer.done(), self._view())
        n_updates = 0
        while len(ready) >= self.cfg.update_batch or (
                final and ready and self.cfg.train_leftover):
            batch = ready[:self.cfg.update_batch]
            ready = ready[len(batch):]
            entries = self.buffer.consume([e.uid for e in batch])
            req = self._update_request(entries, final and not ready)
            if not self.policy.update_gate(req):
                self.metrics.updates_gated += 1
                continue
            self.trainer.submit(req, now=self._now())
            if not self._overlap:
                n_updates += self._drain_trainer(flush=True)
        if self._overlap:
            n_updates += self._drain_trainer(flush=final)
        return n_updates

    def _drain_trainer(self, flush: bool) -> int:
        """Apply completed trainer outcomes: charge un-overlapped trainer
        time as a rollout stall, bump the version, and sync weights.  With
        ``flush`` outstanding submissions are forced to completion (group
        boundary / serialized mode); otherwise only outcomes whose modeled
        time has already passed land (the in-flight mid-rollout path)."""
        now = self._now()
        outcomes = (self.trainer.flush(now) if flush
                    else self.trainer.poll(now))
        for o in outcomes:
            # stall = the part of this update's compute rollout had to
            # wait for.  Charging it advances self._now(), so a queued
            # successor's t_start can never exceed the advanced clock —
            # each outcome stalls at most its own cost.
            stall = max(0.0, o.t_done - self._now())
            if stall > 0:
                self._stall_total += stall
                self.metrics.record(0, stall)
            self.metrics.update_time_total += o.cost
            self.metrics.update_time_stalled += min(o.cost, stall)
            self._apply_outcome(o)
        return len(outcomes)

    def _apply_outcome(self, o) -> None:
        if o.result is not None:
            self.update_results.append(o.result)
            self.metrics.batch_skipped += int(
                o.result.metrics.get("entries_skipped", 0))
        self.version += 1
        self.engine.sync_weights(self.version)
        self.metrics.updates += 1
        if (self._overlap and self.buffer.mode == Mode.ON_POLICY
                and self.engine.active_uids()):
            # the sync landed mid-rollout: on-policy semantics demand
            # every in-flight entry's tokens come from the *current*
            # weights, so invalidate them all (interrupt + scavenge
            # discards their tokens; the next fill re-rolls them fresh).
            # Partial mode instead retains: decoding continues and the
            # per-token version stamps keep the stitched pi_old exact.
            self._harvest_stragglers()

    def _update_request(self, entries: List[BufferEntry],
                        final: bool) -> UpdateRequest:
        stales = [e.staleness(self.version) for e in entries]
        return UpdateRequest(
            entries=entries, version=self.version,
            group_epoch=self.buffer.group_epoch, final=final,
            staleness_mean=sum(stales) / len(stales) if stales else 0.0,
            staleness_max=max(stales, default=0.0))

    # -- driving patterns -----------------------------------------------------

    def run_group(self, prompts: Sequence[Sequence[int]],
                  metas: Optional[Sequence] = None) -> None:
        """Process one group of n*b prompts to full consumption (strict
        grouped loading, paper §3.1 step 5)."""
        assert self.buffer.group_clear(), "previous group not consumed"
        self.buffer.load_prompts(prompts, metas)
        while not self.buffer.group_clear():
            self.rollout_until_harvest()
            remaining = len(self.buffer.unconsumed()) - len(self.buffer.done())
            self.train_ready(final=(remaining == 0))
            self.buffer.check_invariants()
        self._drain_trainer(flush=True)   # no update crosses the barrier
        self.buffer.advance_group()

    def run_steps(self, n_updates: int) -> None:
        """Barrier-free driving (ungrouped ablation): keep harvesting and
        training until `n_updates` updates or the prompt source dries up."""
        while self.metrics.updates < n_updates:
            self.rollout_until_harvest()
            n = self.train_ready(final=False)
            if getattr(self.policy, "prompt_stream", None) is not None:
                continue   # more prompts may still arrive
            if not self.buffer.unconsumed():
                break
            if n == 0 and not (self.buffer.pending() or
                               self.buffer.running()):
                break   # leftover smaller than update_batch; final never
                        # comes without a group barrier
        self._drain_trainer(flush=True)   # deliver overlapped stragglers

    def run_queued(self) -> None:
        """Process every policy-queued group to consumption (pipelined
        lookahead: next-group prompts fill otherwise-idle slots)."""
        policy = self.policy
        assert hasattr(policy, "has_queued"), \
            f"policy {policy.name!r} does not queue groups"
        while policy.has_queued() or self.buffer.unconsumed():
            if not self.buffer.unconsumed() and policy.has_queued():
                prompts, metas = policy.pop_group()
                if prompts:
                    self.buffer.load_prompts(prompts, metas)
                continue
            self.rollout_until_harvest()
            # `final` judged on the CURRENT epoch: next-group entries in
            # flight must not block the current group's leftover batch
            epoch = self.buffer.group_epoch
            remaining = sum(1 for e in self.buffer.unconsumed()
                            if e.lifecycle <= epoch
                            and e.state != EntryState.DONE)
            self.train_ready(final=(remaining == 0))
            self.buffer.check_invariants()
            if self.buffer.current_group_clear() and not self.buffer.group_clear():
                self.buffer.advance_group(strict=False)
            elif self.buffer.group_clear():
                self.buffer.advance_group()
        self._drain_trainer(flush=True)   # deliver overlapped stragglers
