"""Scheduling policies: the part of the controller family that actually
differs between strategies, split out from the orchestration mechanics
(see repro_torch.core.orchestrator).

A :class:`SchedulerPolicy` answers five questions; everything else
(engine feeding, event plumbing, scavenging, metrics, weight sync, group
advancement) is owned by the :class:`~repro_torch.core.orchestrator.RolloutOrchestrator`:

  * ``select_fill(pending, free_slots)`` — which pending entries take the
    freed engine slots (oversubscription order);
  * ``harvest_now(view)`` — when to stop decoding and early-terminate the
    stragglers (paper §3.1 step 2; ``False`` forever = wait-for-all
    baseline);
  * ``train_order_key(entry)`` / ``order_ready(ready, view)`` — how ready
    trajectories are ordered into update batches (the micro-curriculum);
  * ``admit_next_group(view)`` — whether/what new prompts may enter the
    buffer outside the strict group barrier (ungrouped streaming, pipelined
    lookahead);
  * ``update_gate(request)`` — PipelineRL-style off-policy control: veto a
    too-stale update batch before it reaches the trainer.

Policies are registered by name so benchmarks, CLIs, and configs select
them declaratively::

    from repro_torch.core.policy import make_policy
    policy = make_policy("sorted", fill_policy="fresh_first")

Writing a new strategy is ~30 lines: subclass :class:`BasePolicy`,
override the hooks that differ, and decorate with ``@register_policy``
(see :class:`LengthBinPackingPolicy` for a worked example).
"""
from __future__ import annotations

import dataclasses
import heapq
import random
from typing import (TYPE_CHECKING, Any, Callable, Dict, Iterator, List,
                    Optional, Protocol, Sequence, Tuple, runtime_checkable)

from repro_torch.core.buffer import BufferEntry

if TYPE_CHECKING:   # avoid the policy<->orchestrator import cycle
    from repro_torch.core.orchestrator import UpdateRequest


@dataclasses.dataclass(frozen=True)
class SchedView:
    """Read-only scheduling snapshot handed to policy hooks.

    Counts only — policies decide, the orchestrator mutates.
    """
    pending: int              # entries waiting for a slot
    running: int              # entries occupying slots
    done: int                 # finished, awaiting training
    unconsumed: int           # pending + running + done
    free_slots: int
    capacity: int
    group_epoch: int
    version: int              # trainer policy version
    update_batch: int
    harvest_threshold: int    # resolved target for this rollout phase
    next_epoch_load_allowed: bool = True   # lookahead budget not exhausted
    # current-epoch variants (== the totals unless a relaxed-barrier
    # policy admitted next-group entries early)
    done_current: int = 0
    unconsumed_current: int = 0


@dataclasses.dataclass
class AdmitRequest:
    """Prompts a policy wants loaded into the buffer outside run_group."""
    prompts: List[List[int]]
    metas: Optional[List[Any]] = None
    next_epoch: bool = False   # load as group_epoch + 1 (pipelined lookahead)


@runtime_checkable
class SchedulerPolicy(Protocol):
    """The hooks that differ between scheduling strategies."""

    name: str
    early_termination: bool     # harvest interrupts + scavenges stragglers
    strict_group_barrier: bool  # advance_group asserts full consumption
    ordered_training: bool      # order_ready is monotone in train_order_key

    def select_fill(self, pending: Sequence[BufferEntry],
                    free_slots: int) -> List[BufferEntry]: ...

    def harvest_now(self, view: SchedView) -> bool: ...

    def train_order_key(self, entry: BufferEntry) -> Any: ...

    def order_ready(self, ready: Sequence[BufferEntry],
                    view: SchedView) -> List[BufferEntry]: ...

    def admit_next_group(self, view: SchedView) -> Optional[AdmitRequest]: ...

    def update_gate(self, request: "UpdateRequest") -> bool: ...


class BasePolicy:
    """Default hook implementations: SortedRL-style behaviour.

    Subclasses override only what differs; the defaults are the paper's
    length-aware strategy (resume-first fill, threshold harvest,
    shortest-first training, strict group barrier, no gate).
    """

    name = "base"
    early_termination = True
    strict_group_barrier = True
    ordered_training = True

    # -- engine feeding ----------------------------------------------------

    def select_fill(self, pending: Sequence[BufferEntry],
                    free_slots: int) -> List[BufferEntry]:
        # top-free selection, not a full sort — this runs every decode step
        return heapq.nsmallest(free_slots, pending,
                               key=lambda e: (-e.gen_len, len(e.prompt)))

    # -- harvest -----------------------------------------------------------

    def harvest_now(self, view: SchedView) -> bool:
        return view.done >= view.harvest_threshold

    # -- training order ----------------------------------------------------

    def train_order_key(self, entry: BufferEntry) -> Any:
        return entry.gen_len

    def order_ready(self, ready: Sequence[BufferEntry],
                    view: SchedView) -> List[BufferEntry]:
        return sorted(ready, key=self.train_order_key)

    # -- admission beyond the group barrier --------------------------------

    def admit_next_group(self, view: SchedView) -> Optional[AdmitRequest]:
        return None

    # -- off-policy control ------------------------------------------------

    def update_gate(self, request: "UpdateRequest") -> bool:
        return True


class DelegatingPolicy(BasePolicy):
    """A policy wrapper: every hook forwards to a wrapped ``inner``
    policy, and the contract flags mirror the inner policy's.

    This is the extension point for layers that compose *with* any
    scheduling strategy instead of replacing it — the serving tier's
    admission controllers (``repro_torch.serve.tenants.ServingPolicy``)
    override only ``admit_next_group`` on top of this base, so fill /
    harvest / training-order behaviour stays whatever the wrapped
    strategy says.
    """

    name = "delegating"

    def __init__(self, inner: SchedulerPolicy):
        self.inner = inner
        self.early_termination = inner.early_termination
        self.strict_group_barrier = inner.strict_group_barrier
        self.ordered_training = inner.ordered_training

    def select_fill(self, pending, free_slots):
        return self.inner.select_fill(pending, free_slots)

    def harvest_now(self, view: SchedView) -> bool:
        return self.inner.harvest_now(view)

    def train_order_key(self, entry: BufferEntry):
        return self.inner.train_order_key(entry)

    def order_ready(self, ready, view: SchedView):
        return self.inner.order_ready(ready, view)

    def admit_next_group(self, view: SchedView) -> Optional[AdmitRequest]:
        return self.inner.admit_next_group(view)

    def update_gate(self, request: "UpdateRequest") -> bool:
        return self.inner.update_gate(request)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., SchedulerPolicy]] = {}

# registry entries that live outside this module (they import it, so
# they cannot be imported at module-init time without a cycle); loaded
# on first registry use so `make_policy("serving")` works everywhere
_EXTENSION_MODULES = ("repro_torch.serve",)
_extensions_loaded = False


def _load_extensions() -> None:
    global _extensions_loaded
    if _extensions_loaded:
        return
    _extensions_loaded = True
    import importlib
    for mod in _EXTENSION_MODULES:
        importlib.import_module(mod)


def register_policy(name: str):
    """Class/factory decorator adding a policy to the by-name registry."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def make_policy(name: str, **kwargs) -> SchedulerPolicy:
    _load_extensions()
    if name not in _REGISTRY:
        raise KeyError(f"unknown policy {name!r}; "
                       f"registered: {available_policies()}")
    return _REGISTRY[name](**kwargs)


def available_policies() -> List[str]:
    _load_extensions()
    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# the paper strategies (+ the beyond-paper pipelined variant)
# ---------------------------------------------------------------------------

@register_policy("sorted")
class SortedPolicy(BasePolicy):
    """Paper §3.1/§3.3 length-aware strategy.  ``fill_policy`` is the
    beyond-paper slot-fill study: 'resume_first' (default) schedules
    scavenged partials before fresh prompts — bounds their staleness and
    finishes long stragglers early; 'fresh_first' defers partials; 'fifo'
    ignores progress."""

    name = "sorted"

    def __init__(self, fill_policy: str = "resume_first"):
        assert fill_policy in ("resume_first", "fresh_first", "fifo")
        self.fill_policy = fill_policy

    def select_fill(self, pending, free_slots):
        if self.fill_policy == "resume_first":
            return heapq.nsmallest(free_slots, pending,
                                   key=lambda e: (-e.gen_len, len(e.prompt)))
        if self.fill_policy == "fresh_first":
            return heapq.nsmallest(free_slots, pending,
                                   key=lambda e: (e.gen_len, len(e.prompt)))
        return list(pending[:free_slots])   # 'fifo': keep load order


@register_policy("baseline")
class BaselinePolicy(BasePolicy):
    """Canonical baseline: FIFO fill, wait for ALL to finish (no early
    termination — the bubble), then shuffled update batches over the same
    data (off-policy when update_batch < rollout size)."""

    name = "baseline"
    early_termination = False
    ordered_training = False

    def __init__(self, shuffle_seed: int = 0):
        self.shuffle_seed = shuffle_seed

    def select_fill(self, pending, free_slots):
        return list(pending[:free_slots])

    def harvest_now(self, view: SchedView) -> bool:
        return False   # decode until the engine drains

    def order_ready(self, ready, view):
        out = list(ready)
        random.Random(self.shuffle_seed + view.version).shuffle(out)
        return out


@register_policy("posthoc_sort")
class PostHocSortPolicy(BaselinePolicy):
    """Ablation §4.4.2: same data/timing as the baseline but batches sorted
    by length after the fact — the off-policiness stays baseline-high."""

    name = "posthoc_sort"
    ordered_training = True

    def order_ready(self, ready, view):
        return sorted(ready, key=self.train_order_key)


@register_policy("ungrouped")
class UngroupedPolicy(SortedPolicy):
    """Ablation §4.4.2 «disabled grouped rollout»: oversubscription and
    shortest-first harvesting WITHOUT the group barrier — new prompts are
    admitted from ``prompt_stream`` whenever slots free up, so short
    responses dominate and long prompts starve (the collapse the paper
    shows)."""

    name = "ungrouped"
    strict_group_barrier = False

    def __init__(self, prompt_stream: Optional[
            Iterator[Tuple[List[int], Any]]] = None,
            fill_policy: str = "resume_first"):
        super().__init__(fill_policy)
        self.prompt_stream = prompt_stream   # iterator of (prompt, meta)

    def admit_next_group(self, view: SchedView) -> Optional[AdmitRequest]:
        if self.prompt_stream is None:
            return None
        prompts, metas = [], []
        # keep pulling fresh prompts — no group barrier
        while view.pending + len(prompts) < view.free_slots:
            try:
                prompt, meta = next(self.prompt_stream)
            except StopIteration:
                self.prompt_stream = None
                break
            prompts.append(prompt)
            metas.append(meta)
        return AdmitRequest(prompts, metas) if prompts else None


@register_policy("pipelined")
class PipelinedPolicy(SortedPolicy):
    """BEYOND-PAPER extension: relaxed group barrier.

    The paper's grouped loading leaves a drain bubble at each group tail
    (the last update_batch of stragglers can't fill the engine).  This
    policy admits prompts of group g+1 into otherwise-idle slots while
    group g stragglers finish.  Group-g entries still train before any
    group-g+1 entry (``train_order_key`` leads with the lifecycle), so the
    curriculum and no-starvation guarantees are preserved; only the strict
    "no new prompts until clear" rule is relaxed."""

    name = "pipelined"
    strict_group_barrier = False

    def __init__(self, lookahead: int = 1,
                 fill_policy: str = "resume_first"):
        super().__init__(fill_policy)
        if lookahead != 1:
            # the buffer's lifecycle accounting (and check_invariants)
            # supports exactly one group of lookahead
            raise NotImplementedError("pipelined lookahead is fixed at 1")
        self.lookahead = lookahead
        self._next_groups: List[Tuple[List, Optional[List]]] = []

    def queue_group(self, prompts, metas=None) -> None:
        self._next_groups.append((list(prompts), metas))

    def has_queued(self) -> bool:
        return bool(self._next_groups)

    def pop_group(self) -> Tuple[List, Optional[List]]:
        return self._next_groups.pop(0)

    def admit_next_group(self, view: SchedView) -> Optional[AdmitRequest]:
        prompts: List = []
        metas: List = []
        pending = view.pending
        # admit next-group prompts only into slots the current group
        # cannot fill
        while (view.free_slots > pending and self._next_groups
               and view.next_epoch_load_allowed):
            g_prompts, g_metas = self._next_groups[0]
            take = min(view.free_slots - pending, len(g_prompts))
            prompts.extend(g_prompts[:take])
            metas.extend(g_metas[:take] if g_metas else [None] * take)
            del g_prompts[:take]
            if g_metas:
                del g_metas[:take]
            if not g_prompts:
                self._next_groups.pop(0)
            pending += take
        if not prompts:
            return None
        return AdmitRequest(prompts, metas, next_epoch=True)

    def train_order_key(self, entry: BufferEntry):
        # strictly lifecycle-ordered so group g trains before group g+1
        # (curriculum preserved)
        return (entry.lifecycle, entry.gen_len)

    def harvest_now(self, view: SchedView) -> bool:
        # count only current-epoch completions: deferred next-group DONE
        # entries must not satisfy the threshold, or the last current-group
        # stragglers would be interrupted forever without progress
        return view.done_current >= min(view.harvest_threshold,
                                        view.unconsumed_current)

    def order_ready(self, ready, view):
        # next-epoch entries may finish early (they fill idle slots) but
        # must not TRAIN before the current group is fully consumed —
        # defer them until the orchestrator advances the epoch
        current = [e for e in ready if e.lifecycle <= view.group_epoch]
        return sorted(current, key=self.train_order_key)


@register_policy("length_binned")
class LengthBinPackingPolicy(BasePolicy):
    """Registry demo (RollPacker-flavoured): pack update batches by
    power-of-two length bin so batch members pad to the same bucket, and
    gate batches whose mean staleness exceeds ``max_staleness``
    (PipelineRL-style off-policy cap).  A new strategy really is this
    small: two hook overrides on top of :class:`BasePolicy`."""

    name = "length_binned"

    def __init__(self, bin_width_log2: int = 5,
                 max_staleness: Optional[float] = None):
        self.bin_width_log2 = bin_width_log2
        self.max_staleness = max_staleness

    def train_order_key(self, entry: BufferEntry):
        # bin index first: batches cluster into shared padding buckets
        return (entry.gen_len >> self.bin_width_log2, entry.gen_len)

    def update_gate(self, request: "UpdateRequest") -> bool:
        if self.max_staleness is None or request.final:
            return True
        return request.staleness_mean <= self.max_staleness
