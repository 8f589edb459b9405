"""Engine protocol shared by the real JAX slot engine (repro_torch.rollout.engine)
and the discrete-event simulator (repro_torch.rollout.sim).

The controller only speaks this interface, so scheduling policies are
validated against the simulator and executed unchanged against the real
engine — the co-design the paper's infrastructure section describes.

Beyond the required surface, engines may implement an optional
**migration capability** discovered by duck typing (used by
``repro_torch.rollout.group.EngineGroup`` for work stealing and drain-phase
tail packing):

  * ``export_entry(uid) -> Optional[dict]`` — snapshot an in-flight slot
    or resident KV for transfer (pure read; ``None`` = unsupported);
  * ``import_entry(handle) -> bool`` — land the snapshot here, False
    (engine unchanged) when it cannot accept;
  * ``discard_entry(uid)`` — drop the donor copy once accepted.

Engines without these methods simply never migrate (the group falls back
to release-and-re-prefill).

Two further optional capabilities support fault tolerance and
elasticity (again duck-typed, again optional):

  * ``throttle(factor)`` — scale the engine's decode step cost by
    ``factor`` (the simulator models a degraded replica; engines on a
    real wall clock may ignore it);
  * ``shutdown()`` — fence the engine: release every slot and drop all
    resident KV, so a killed or scaled-down replica holds no pages.

:class:`FaultInjector` is the deterministic fault plan the
:class:`~repro_torch.rollout.group.EngineGroup` consults at each group step —
it decides WHEN a replica is killed / stalled / slowed; the group owns
HOW (re-homing, re-roll, accounting).
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.buffer import BufferEntry


# -----------------------------------------------------------------------------
# fault injection (chaos testing surface)
# -----------------------------------------------------------------------------

FAULT_KINDS = ("kill", "stall", "slow")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault against one replica of an EngineGroup.

    ``step`` is the 1-based group step index at which the fault fires
    (faults apply at the START of that ``step()`` call, before any
    replica is dispatched).  Kinds:

      * ``kill``  — the replica fails permanently (fail-stop, detected
        at the step boundary).  Its in-flight uids are re-homed to
        survivors (KV migrated when the group runs ``migrate_kv=True``)
        or released for a re-roll under the current policy version;
      * ``stall`` — the replica makes no progress for ``duration`` group
        steps, then resumes (a hung collective / network partition);
      * ``slow``  — the replica's decode step cost is multiplied by
        ``factor`` for ``duration`` group steps (thermal throttling, a
        degraded host).  Ignored by engines without ``throttle()``.
    """
    step: int
    replica: int
    kind: str
    duration: int = 1
    factor: float = 4.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.step < 1:
            raise ValueError(f"fault step must be >= 1, got {self.step}")


class FaultInjector:
    """A deterministic fault plan: which replica fails, how, and at which
    group step.  Purely declarative — the EngineGroup polls :meth:`due`
    once per ``step()`` and applies the returned faults itself, so the
    same plan replayed against the same workload produces the same run.

    Accepts :class:`FaultEvent` instances or plain tuples
    ``(step, replica, kind[, duration[, factor]])`` (the
    ``SessionConfig.fault_plan`` wire format).
    """

    def __init__(self, plan: Optional[Sequence] = None):
        events = []
        for item in (plan or []):
            if not isinstance(item, FaultEvent):
                item = FaultEvent(*item)
            events.append(item)
        self.plan: List[FaultEvent] = sorted(
            events, key=lambda f: (f.step, f.replica))
        # step -> events index: due() is polled every group step, and the
        # serving loop steps without a horizon, so the lookup must not
        # scan the whole plan each time
        self._by_step: dict = {}
        for f in self.plan:
            self._by_step.setdefault(f.step, []).append(f)

    @classmethod
    def random_plan(cls, seed: int, n_replicas: int,
                    horizon: Optional[int] = None,
                    n_faults: int = 1,
                    kinds: Sequence[str] = FAULT_KINDS,
                    max_duration: int = 4) -> "FaultInjector":
        """Seed-deterministic random plan: ``n_faults`` faults drawn
        against ``n_replicas`` replicas.  With a ``horizon`` the steps
        are uniform over ``[1, horizon]`` (finite runs); with
        ``horizon=None`` they are drawn from a geometric-shaped
        distribution with unbounded support (mean ~32 steps), so plans
        compose with the serving tier's unbounded continuous-batching
        loop — a step beyond whatever the run reaches simply never
        fires.  String seeding keeps the draw stable across processes
        and platforms."""
        rng = random.Random(f"fault-plan:{seed}")
        def draw_step() -> int:
            if horizon is None:
                return 1 + int(rng.expovariate(1.0 / 32.0))
            return rng.randint(1, max(1, horizon))
        plan = [FaultEvent(step=draw_step(),
                           replica=rng.randrange(n_replicas),
                           kind=kinds[rng.randrange(len(kinds))],
                           duration=rng.randint(1, max_duration))
                for _ in range(n_faults)]
        return cls(plan)

    def due(self, step: int) -> List[FaultEvent]:
        """Faults scheduled to fire at group step ``step`` (1-based)."""
        return self._by_step.get(step, [])


@dataclasses.dataclass
class StepEvent:
    """One slot's outcome for one decode step."""
    uid: int
    token: int
    logprob: float
    done: bool
    finish_reason: Optional[str] = None   # set when done


class SlotTable:
    """Structure-of-arrays host state for a fixed pool of decode slots.

    Shared by the real SlotEngine (where rows mirror the device KV cache)
    and the SimEngine (where ``kv_start``/``gen_budget`` double as the
    scavenged prefix and the hidden length target).  All mutators take
    index *arrays*, so an engine can retire or advance every slot of a
    step in a handful of numpy ops instead of a per-slot Python loop.

    Event-order contract: engines emit StepEvents in ascending slot
    order (the order of :meth:`active_indices`), which is stable across
    steps for as long as a request occupies its slot.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.uid = np.full(capacity, -1, np.int64)
        self.active = np.zeros(capacity, bool)
        self.next_token = np.zeros(capacity, np.int32)
        self.kv_len = np.zeros(capacity, np.int32)
        self.kv_start = np.zeros(capacity, np.int32)
        self.gen_count = np.zeros(capacity, np.int32)
        self.gen_budget = np.zeros(capacity, np.int32)

    # -- queries ----------------------------------------------------------

    def free_count(self) -> int:
        return int((~self.active).sum())

    def free_indices(self) -> np.ndarray:
        return np.flatnonzero(~self.active)

    def active_indices(self) -> np.ndarray:
        return np.flatnonzero(self.active)

    def active_uids(self) -> List[int]:
        return [int(u) for u in self.uid[self.active]]

    def select(self, uids: Optional[Sequence[int]] = None) -> np.ndarray:
        """Active slot indices, optionally filtered to the given uids."""
        act = self.active_indices()
        if uids is None:
            return act
        wanted = np.asarray(list(uids), np.int64)
        return act[np.isin(self.uid[act], wanted)]

    # -- mutators ---------------------------------------------------------

    def allocate(self, k: int) -> np.ndarray:
        """Lowest k free slot indices (raises if oversubscribed)."""
        free = self.free_indices()
        assert k <= len(free), "not enough free slots"
        return free[:k]

    def release(self, slots: np.ndarray) -> None:
        self.active[slots] = False
        self.uid[slots] = -1


@runtime_checkable
class EngineProtocol(Protocol):
    capacity: int            # Q — max concurrent requests (slot count)

    @property
    def clock(self) -> float:                     # seconds (real or virtual)
        ...

    def free_slots(self) -> int: ...

    def active_uids(self) -> List[int]: ...

    def submit(self, entries: Sequence[BufferEntry], version: int) -> None:
        """Prefill prompts (plus any scavenged prefix in partial mode) into
        free slots.  Raises if not enough slots."""
        ...

    def step(self) -> List[StepEvent]:
        """Advance every active slot one token.  Completed slots are freed
        and reported with done=True."""
        ...

    def interrupt(self, uids: Optional[Sequence[int]] = None) -> List[int]:
        """Early termination: stop the given (default: all) active requests,
        free their slots, and return their uids.  Generated tokens were
        already reported through step()."""
        ...

    def sync_weights(self, version: int) -> None:
        """Make the engine generate with the given policy version (weight
        sync after a trainer update).  The real engine shares the
        TrainState so this is O(1); the simulator models a latency."""
        ...
