"""Feedback-driven fleet autoscaling: observed metrics drive scale events.

The paper's Eq. 4 bubble ratio is exactly an autoscaling signal — idle-slot
time on *running* replicas is capacity the fleet is paying for and not
using — and the serving tier's per-tenant backlog age is the opposite
signal: capacity the fleet is missing.  Until now both were observability
output only and every ``EngineGroup.scale_down``/``scale_up`` call was
manual.  This module closes the loop:

* :class:`AutoscalerPolicy` — a protocol behind a string registry
  (mirroring the scheduler / balancer / admission registries): given an
  :class:`AutoscaleView` of the fleet, propose ``-1`` (shed a replica),
  ``+1`` (add one), or ``0``.  Policies are *pure* deciders; feasibility
  (drainable victim, min/max clamp, cooldown) lives in the controller.

  - ``bubble_target`` — shed when the windowed ``replica_bubble_ratio``
    exceeds a high-water mark (drain-phase tail: RollPacker's "shedding
    is free during drain"), add when free capacity starves pending work
    while the fleet runs hot (windowed bubble under the low-water mark).
  - ``queue_depth`` — serving tier: add when per-tenant backlog age
    threatens SLO deadlines with no free slot to admit the head, shed
    when the ingress is drained and the fleet bubbles (Seer's fleet
    view: an idle replica is reclaimable capacity).

* :class:`MetricsWindow` — a sliding window of :class:`MetricsSnapshot`
  observations on the group clock.  The group's cumulative Eq. 4
  integrals (``replica_busy_time`` / ``replica_cap_time`` in
  ``cache_stats()``) are differenced across the window, so the policy
  sees *recent* bubble, not the whole-run average that a long healthy
  bulk phase would wash out.

* :class:`Autoscaler` — the controller, ticked once per group step by
  the orchestrator.  Hysteresis (a non-zero proposal must persist for
  ``confirm_steps`` consecutive ticks) plus a post-action ``cooldown``
  on the group clock keep chaos-plan faults (a stall window, a kill
  blip) from causing flapping; ``min_replicas``/``max_replicas`` bound
  the fleet; a replica ``factory`` mints warm replicas for ``scale_up``
  (the group syncs them to its weight version; mixed ``cap_total`` is
  fine — ``weighted_tokens`` already routes heterogeneous fleets).

Everything is deterministic: the view is derived from the group's
deterministic accounting, victim selection breaks ties on replica index,
and the event log is reproducible under a fixed workload seed.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Protocol, Tuple,
                    runtime_checkable)

from repro_torch.core.engine_api import EngineProtocol
from repro_torch.core.metrics import MetricsSnapshot


# -----------------------------------------------------------------------------
# windowed metrics view
# -----------------------------------------------------------------------------

class MetricsWindow:
    """Sliding window over (clock, MetricsSnapshot) observations.

    Keeps every observation within ``span`` of the newest plus one older
    observation as the delta base, so :meth:`delta` always spans at least
    ``span`` once enough history exists.  ``bubble()`` is the windowed
    per-replica Eq. 4: idle-slot time over capacity time of *running*
    replicas, differenced across the window."""

    def __init__(self, span: float):
        assert span > 0, "window span must be positive"
        self.span = float(span)
        self._obs: Deque[Tuple[float, MetricsSnapshot]] = deque()

    def push(self, now: float, snap: MetricsSnapshot) -> None:
        self._obs.append((float(now), snap))
        while len(self._obs) > 2 and self._obs[1][0] <= now - self.span:
            self._obs.popleft()

    def __len__(self) -> int:
        return len(self._obs)

    @property
    def covered(self) -> float:
        """Clock span actually covered by the current observations."""
        if len(self._obs) < 2:
            return 0.0
        return self._obs[-1][0] - self._obs[0][0]

    @property
    def full(self) -> bool:
        """Whether the window has accumulated ``span`` of history — shed
        decisions wait for this so a cold fleet's fill phase (briefly
        high bubble) cannot trigger a premature scale_down."""
        return self.covered >= self.span

    def delta(self, key: str) -> float:
        """Windowed increase of a cumulative gauge."""
        if len(self._obs) < 2:
            return 0.0
        new = float(self._obs[-1][1].get(key, 0.0))
        old = float(self._obs[0][1].get(key, 0.0))
        return new - old

    def bubble(self) -> float:
        """Windowed replica_bubble_ratio (Eq. 4 over the window)."""
        cap = self.delta("replica_cap_time")
        if cap <= 0:
            return 0.0
        busy = self.delta("replica_busy_time")
        return max(0.0, (cap - busy) / cap)


# -----------------------------------------------------------------------------
# the policy protocol + registry
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AutoscaleView:
    """What a policy sees each tick — fleet shape, windowed signals, and
    (for serving) backlog pressure.  All fields derive deterministically
    from the group's accounting and the orchestrator's buffer/ingress."""
    now: float                  # group clock at this tick
    alive: int                  # live replicas
    capacity: int               # live fleet slot count
    free_slots: int             # live fleet free slots
    pending: int                # buffer entries waiting for a slot
    running: int                # buffer entries decoding
    window_bubble: float        # windowed replica_bubble_ratio (Eq. 4)
    window_full: bool           # window has span's worth of history
    min_replicas: int
    max_replicas: Optional[int]
    # serving-tier backlog signals (zero outside serving runs)
    queue_backlog: int = 0      # queued requests across tenants
    oldest_wait: float = 0.0    # max head wait across tenant queues
    slo_pressure: float = 0.0   # max head (wait / latency_slo); 0 = no SLO

    @property
    def can_grow(self) -> bool:
        return self.max_replicas is None or self.alive < self.max_replicas

    @property
    def can_shed(self) -> bool:
        return self.alive > max(1, self.min_replicas)


@runtime_checkable
class AutoscalerPolicy(Protocol):
    """propose(view) -> -1 (shed one replica), 0 (hold), +1 (add one)."""

    name: str

    def propose(self, view: AutoscaleView) -> int: ...


_AUTOSCALERS: Dict[str, Callable[..., AutoscalerPolicy]] = {}


def register_autoscaler(name: str):
    def deco(factory):
        _AUTOSCALERS[name] = factory
        return factory
    return deco


def make_autoscaler(name: str, **kwargs) -> AutoscalerPolicy:
    if name not in _AUTOSCALERS:
        raise KeyError(f"unknown autoscaler {name!r}; "
                       f"registered: {available_autoscalers()}")
    return _AUTOSCALERS[name](**kwargs)


def available_autoscalers() -> List[str]:
    return sorted(_AUTOSCALERS)


@register_autoscaler("bubble_target")
class BubbleTargetPolicy:
    """Hold the windowed bubble ratio between two water marks.

    Shed when the windowed Eq. 4 bubble exceeds ``high`` — running
    replicas are collectively idling more than the target, so the tail
    fits on fewer of them (the controller only acts when a victim is
    drainable).  Add when pending work is starved of capacity (zero free
    slots, non-empty pending queue) while the fleet runs *hot*
    (windowed bubble at or under ``low``) — adding capacity when the
    fleet already bubbles would just add idle slots.  The gap between
    the marks is the hysteresis band: a fleet sitting between them is
    left alone."""

    name = "bubble_target"

    def __init__(self, high: float = 0.5, low: float = 0.15):
        assert 0.0 <= low < high <= 1.0, "need 0 <= low < high <= 1"
        self.high = float(high)
        self.low = float(low)

    def propose(self, view: AutoscaleView) -> int:
        if (view.can_grow and view.pending > 0 and view.free_slots <= 0
                and view.window_bubble <= self.low):
            return 1
        if (view.can_shed and view.window_full
                and view.window_bubble >= self.high):
            return -1
        return 0


@register_autoscaler("queue_depth")
class QueueDepthPolicy:
    """Serving tier: scale on per-tenant backlog age vs SLO deadlines.

    Add a replica when a queued head has burned ``wait_frac`` of its
    tenant's ``latency_slo`` waiting (or has waited ``target_wait``
    absolute, for tenants without an SLO) and the fleet has no free slot
    to admit it — backlog age, not raw depth, so a deep-but-fresh burst
    within budget does not trigger growth.  Shed when the ingress is
    fully drained and the windowed bubble shows the fleet idling
    (``idle_bubble``): an idle replica is reclaimable capacity."""

    name = "queue_depth"

    def __init__(self, wait_frac: float = 0.5, target_wait: float = 2.0,
                 idle_bubble: float = 0.5):
        assert 0.0 < wait_frac <= 1.0
        self.wait_frac = float(wait_frac)
        self.target_wait = float(target_wait)
        self.idle_bubble = float(idle_bubble)

    def propose(self, view: AutoscaleView) -> int:
        starved = view.queue_backlog > 0 and view.free_slots <= 0
        aged = (view.slo_pressure >= self.wait_frac
                or view.oldest_wait >= self.target_wait)
        if view.can_grow and starved and aged:
            return 1
        if (view.can_shed and view.window_full
                and view.queue_backlog == 0
                and view.window_bubble >= self.idle_bubble):
            return -1
        return 0


# -----------------------------------------------------------------------------
# the controller
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One acted-on proposal, for logs / benchmarks / tests."""
    t: float                    # group clock when the action fired
    direction: int              # +1 added a replica, -1 shed one
    replica: int                # index added or shed
    window_bubble: float        # signal at decision time


class Autoscaler:
    """Evaluates an :class:`AutoscalerPolicy` each group step and drives
    ``EngineGroup.scale_down``/``scale_up``.

    ``policy`` is a registry name or a policy instance.  ``factory``
    mints a warm replica for scale_up, called with the new replica's
    index (``factory(index) -> EngineProtocol``); without one the
    controller can only shed.  ``window`` and ``cooldown`` are in group
    clock units (modeled seconds for SimEngine fleets).  Hysteresis: a
    non-zero proposal must persist for ``confirm_steps`` consecutive
    ticks before it is acted on, so one noisy step (a stall fault, a
    fill blip) cannot flap the fleet."""

    def __init__(self, policy, *,
                 factory: Optional[Callable[[int], EngineProtocol]] = None,
                 min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 window: float = 1.0,
                 cooldown: float = 0.5,
                 confirm_steps: int = 2,
                 policy_kwargs: Optional[dict] = None):
        if isinstance(policy, str):
            policy = make_autoscaler(policy, **(policy_kwargs or {}))
        assert min_replicas >= 1, "min_replicas must be >= 1"
        assert max_replicas is None or max_replicas >= min_replicas
        assert confirm_steps >= 1
        self.policy: AutoscalerPolicy = policy
        self.factory = factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = max_replicas
        self.cooldown = float(cooldown)
        self.confirm_steps = int(confirm_steps)
        self.window = MetricsWindow(window)
        self.events: List[ScaleEvent] = []
        self.last_view: Optional[AutoscaleView] = None
        self._streak_dir = 0        # direction of the current streak
        self._streak = 0            # consecutive ticks proposing it
        self._last_action_t: Optional[float] = None

    # -- observation -------------------------------------------------------

    def observe(self, group) -> AutoscaleView:
        """Push the group's current snapshot and build this tick's view
        (without acting) — also the hook tests/benchmarks use to read
        the windowed signal at run end."""
        now = float(group.clock)
        self.window.push(now, group.cache_stats())
        return self._view(group, now)

    def _view(self, group, now: float, *, pending: int = 0, running: int = 0,
              queue_backlog: int = 0, oldest_wait: float = 0.0,
              slo_pressure: float = 0.0) -> AutoscaleView:
        return AutoscaleView(
            now=now, alive=sum(group.alive), capacity=group.capacity,
            free_slots=group.free_slots(), pending=pending, running=running,
            window_bubble=self.window.bubble(), window_full=self.window.full,
            min_replicas=self.min_replicas, max_replicas=self.max_replicas,
            queue_backlog=queue_backlog, oldest_wait=oldest_wait,
            slo_pressure=slo_pressure)

    # -- the per-step tick -------------------------------------------------

    def tick(self, group, *, pending: int = 0, running: int = 0,
             queue_backlog: int = 0, oldest_wait: float = 0.0,
             slo_pressure: float = 0.0) -> Optional[ScaleEvent]:
        """One observe -> propose -> (maybe) act cycle.  Returns the
        ScaleEvent when an action fired, else None."""
        now = float(group.clock)
        self.window.push(now, group.cache_stats())
        view = self._view(group, now, pending=pending, running=running,
                          queue_backlog=queue_backlog,
                          oldest_wait=oldest_wait, slo_pressure=slo_pressure)
        self.last_view = view
        want = self.policy.propose(view)
        if want == 0:
            self._streak_dir, self._streak = 0, 0
            return None
        if want == self._streak_dir:
            self._streak += 1
        else:
            self._streak_dir, self._streak = want, 1
        if self._streak < self.confirm_steps:
            return None
        if (self._last_action_t is not None
                and now - self._last_action_t < self.cooldown):
            return None             # cooling down; streak stays armed
        if want > 0:
            return self._grow(group, view, now)
        return self._shed(group, view, now)

    def _record(self, now: float, direction: int, replica: int,
                view: AutoscaleView) -> ScaleEvent:
        ev = ScaleEvent(t=now, direction=direction, replica=replica,
                        window_bubble=view.window_bubble)
        self.events.append(ev)
        self._last_action_t = now
        self._streak_dir, self._streak = 0, 0
        return ev

    def _grow(self, group, view: AutoscaleView,
              now: float) -> Optional[ScaleEvent]:
        if self.factory is None or not view.can_grow:
            return None
        idx = group.scale_up(self.factory(len(group.replicas)))
        return self._record(now, +1, idx, view)

    def _shed(self, group, view: AutoscaleView,
              now: float) -> Optional[ScaleEvent]:
        if not view.can_shed:
            return None
        victim = self._pick_victim(group)
        if victim is None:
            return None             # nothing drainable; stay armed
        group.scale_down(victim)
        return self._record(now, -1, victim, view)

    def _pick_victim(self, group) -> Optional[int]:
        """The emptiest live replica, if it is drainable: idle outright,
        or its in-flight tail fits in the survivors' free slots (so the
        scale_down migrates/resubmits instead of re-rolling work).
        Deterministic: ties break on replica index."""
        alive = [i for i, a in enumerate(group.alive) if a]
        if len(alive) <= 1:
            return None
        counts = {i: len(group.replicas[i].active_uids()) for i in alive}
        victim = min(alive, key=lambda i: (counts[i], i))
        survivor_free = sum(group.replicas[i].free_slots()
                            for i in alive if i != victim)
        if counts[victim] == 0 or counts[victim] <= survivor_free:
            return victim
        return None
