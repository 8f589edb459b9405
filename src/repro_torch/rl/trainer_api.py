"""The Trainer protocol: a typed, registry-backed front for the trainer.

Historically the orchestrator took a bare ``TrainFn`` callable and ran it
inline — `train_ready` blocked rollout until the update (and the weight
sync behind it) returned, so at scale the update step became the new
bubble.  This module replaces that hand-off with a small protocol,

    trainer.submit(req, now)   # hand a batch over; never blocks rollout
    trainer.poll(now)          # outcomes whose modeled time has passed
    trainer.flush(now)         # complete everything outstanding

plus capability flags (``supports_overlap``), behind a string registry
mirroring the engine / policy / admission registries::

    trainer = make_trainer("streaming", fn=train_fn, update_cost=2.0)

Two implementations ship:

* ``"sync"``  — the classical serialized hand-off.  ``submit`` runs the
  wrapped fn immediately and the outcome's modeled completion time is
  ``now + cost``: the orchestrator charges the full update as a rollout
  stall, exactly the pre-protocol behavior.
* ``"streaming"`` — PipelineRL-style overlap.  ``submit`` enqueues the
  batch on a modeled single-stream trainer timeline (``t_start = max(now,
  busy_until)``); ``poll(now)`` completes outcomes whose ``t_done`` has
  passed, so update compute runs *concurrently* with continued rollout
  and only the un-overlapped remainder ever stalls the engine clock.

**Deprecation note — bare callables:** passing a plain
``Callable[[UpdateRequest], Optional[UpdateResult]]`` where a Trainer is
expected still works everywhere (``as_trainer`` wraps it in a zero-cost
``SyncTrainer``), but it is a compatibility shim: new call sites should
build a trainer via ``make_trainer`` so overlap, cost modeling, and
capability flags compose.

This module is deliberately jax-free (the heavy batch assembly lives in
:mod:`repro_torch.rl.trainer`, which re-exports this API), so the orchestrator
and the sim-only tests can import it without touching jax.
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional, Protocol,
                    Union, runtime_checkable)

if TYPE_CHECKING:   # import cycle: orchestrator imports as_trainer lazily
    from repro_torch.core.orchestrator import UpdateRequest, UpdateResult

# modeled seconds of trainer compute for one update batch: a constant, or
# a callable of the request (e.g. tokens-proportional)
CostSpec = Union[float, Callable[["UpdateRequest"], float]]


@dataclasses.dataclass
class TrainOutcome:
    """One completed update on the trainer timeline."""
    request: "UpdateRequest"
    result: Optional["UpdateResult"]
    t_submit: float           # when the orchestrator handed the batch over
    t_start: float            # when trainer compute began (queue delay)
    t_done: float             # when the update (incl. compute) completed
    cost: float               # modeled trainer compute seconds


@runtime_checkable
class Trainer(Protocol):
    """Capability-flagged trainer front (see module docstring)."""

    name: str
    # True when poll() may complete submissions strictly after submit()
    # returned — the orchestrator requires this for overlap mode
    supports_overlap: bool

    def submit(self, req: "UpdateRequest", now: float) -> None:
        """Accept one update batch at modeled time ``now``."""
        ...

    def poll(self, now: float) -> List[TrainOutcome]:
        """Outcomes whose modeled completion time has passed ``now``."""
        ...

    def flush(self, now: float) -> List[TrainOutcome]:
        """Complete every outstanding submission (t_done may exceed now)."""
        ...

    @property
    def pending(self) -> int:
        """Submitted-but-uncompleted batch count."""
        ...


def _resolve_cost(cost: CostSpec, req: "UpdateRequest") -> float:
    c = cost(req) if callable(cost) else cost
    if c < 0:
        raise ValueError(f"trainer update cost must be >= 0, got {c}")
    return float(c)


class SyncTrainer:
    """Serialized hand-off: the update runs inside ``submit`` and its
    whole ``cost`` lands on the rollout clock as a stall."""

    name = "sync"
    supports_overlap = False

    def __init__(self, fn: Callable, update_cost: CostSpec = 0.0,
                 update_cost_per_token: float = 0.0):
        self.fn = fn
        self.update_cost = update_cost
        self.update_cost_per_token = update_cost_per_token
        self._done: List[TrainOutcome] = []

    def _cost(self, req: "UpdateRequest") -> float:
        c = _resolve_cost(self.update_cost, req)
        if self.update_cost_per_token:
            c += self.update_cost_per_token * sum(e.gen_len
                                                  for e in req.entries)
        return c

    def submit(self, req: "UpdateRequest", now: float) -> None:
        cost = self._cost(req)
        result = self.fn(req)
        self._done.append(TrainOutcome(request=req, result=result,
                                       t_submit=now, t_start=now,
                                       t_done=now + cost, cost=cost))

    def poll(self, now: float) -> List[TrainOutcome]:
        out, self._done = self._done, []
        return out

    def flush(self, now: float) -> List[TrainOutcome]:
        return self.poll(now)

    @property
    def pending(self) -> int:
        return len(self._done)


class StreamingTrainer(SyncTrainer):
    """Overlapped hand-off on a modeled single-stream trainer timeline.

    ``submit`` only enqueues; the wrapped fn runs when ``poll`` observes
    the modeled completion time passing (or at ``flush``), so the weight
    sync behind each outcome lands mid-rollout and rollout pays only the
    part of the update that did NOT overlap."""

    name = "streaming"
    supports_overlap = True

    def __init__(self, fn: Callable, update_cost: CostSpec = 0.0,
                 update_cost_per_token: float = 0.0):
        super().__init__(fn, update_cost, update_cost_per_token)
        self._queue: List[TrainOutcome] = []
        self._busy_until = 0.0

    def submit(self, req: "UpdateRequest", now: float) -> None:
        cost = self._cost(req)
        t_start = max(now, self._busy_until)
        self._busy_until = t_start + cost
        self._queue.append(TrainOutcome(request=req, result=None,
                                        t_submit=now, t_start=t_start,
                                        t_done=t_start + cost, cost=cost))

    def _complete(self, o: TrainOutcome) -> TrainOutcome:
        o.result = self.fn(o.request)
        return o

    def poll(self, now: float) -> List[TrainOutcome]:
        out = []
        while self._queue and self._queue[0].t_done <= now:
            out.append(self._complete(self._queue.pop(0)))
        return out

    def flush(self, now: float) -> List[TrainOutcome]:
        out = [self._complete(o) for o in self._queue]
        self._queue = []
        return out

    @property
    def pending(self) -> int:
        return len(self._queue)


# ---------------------------------------------------------------------------
# registry (mirrors repro_torch.core.policy / rollout.group / serve.tenants)
# ---------------------------------------------------------------------------

_TRAINERS: Dict[str, Callable[..., Trainer]] = {}


def register_trainer(name: str, factory: Callable[..., Trainer]) -> None:
    _TRAINERS[name] = factory


def make_trainer(name: str, **kwargs) -> Trainer:
    """Build a registered trainer by name (``"sync"`` / ``"streaming"``).

    kwargs are forwarded to the factory — typically ``fn=`` (the update
    callable), ``update_cost=`` (seconds per batch, or a callable of the
    request) and ``update_cost_per_token=``.
    """
    if name not in _TRAINERS:
        raise KeyError(f"unknown trainer {name!r}; "
                       f"registered: {available_trainers()}")
    return _TRAINERS[name](**kwargs)


def available_trainers() -> List[str]:
    return sorted(_TRAINERS)


register_trainer("sync", SyncTrainer)
register_trainer("streaming", StreamingTrainer)


def as_trainer(obj: Union[Trainer, Callable]) -> Trainer:
    """Coerce a trainer-or-callable to the Trainer protocol.

    A Trainer passes through; a bare ``TrainFn`` callable (the deprecated
    pre-protocol hand-off) is wrapped in a zero-cost :class:`SyncTrainer`,
    which reproduces the old inline-call semantics exactly.
    """
    if hasattr(obj, "submit") and hasattr(obj, "poll"):
        return obj          # already a Trainer (duck-typed on purpose)
    if not callable(obj):
        raise TypeError(f"expected a Trainer or a TrainFn callable, "
                        f"got {type(obj).__name__}")
    return SyncTrainer(obj)


__all__ = ["CostSpec", "TrainOutcome", "Trainer", "SyncTrainer",
           "StreamingTrainer", "register_trainer", "make_trainer",
           "available_trainers", "as_trainer"]
