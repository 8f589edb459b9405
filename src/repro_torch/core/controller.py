"""Back-compat controller shims over the policy/orchestrator split.

The controller family used to re-implement the fill/step/harvest/train
loop four times.  That loop now lives once in
:class:`repro_torch.core.orchestrator.RolloutOrchestrator`; the strategies are
:class:`repro_torch.core.policy.SchedulerPolicy` objects selected by name from
a registry.  New code should wire those directly::

    from repro_torch.core.orchestrator import RolloutOrchestrator, SortedRLConfig
    from repro_torch.core.policy import make_policy

    orch = RolloutOrchestrator(engine, buffer, cfg,
                               make_policy("sorted"), train_fn)
    orch.run_group(prompts, metas)

The classes below keep the historical constructor signatures (including
the bare ``(entries, version)`` train callback) and map 1:1 onto a
policy:

    SortedRLController    -> make_policy("sorted", fill_policy=...)
    CanonicalController   -> make_policy("baseline" | "posthoc_sort")
    UngroupedController   -> make_policy("ungrouped", prompt_stream=...)
    PipelinedController   -> make_policy("pipelined", lookahead=...)
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.core.buffer import BufferEntry, StatefulRolloutBuffer
from repro_torch.core.engine_api import EngineProtocol
from repro_torch.core.metrics import RolloutMetrics
from repro_torch.core.orchestrator import (RolloutOrchestrator, SortedRLConfig,
                                     UpdateRequest)
from repro_torch.core.policy import (BaselinePolicy, PipelinedPolicy,
                               PostHocSortPolicy, SortedPolicy,
                               UngroupedPolicy)

__all__ = ["SortedRLConfig", "TrainFn", "SortedRLController",
           "CanonicalController", "UngroupedController",
           "PipelinedController"]

# legacy trainer callback: (entries, version) -> None
TrainFn = Callable[[List[BufferEntry], int], None]


def _wrap_legacy(train_fn: TrainFn):
    def typed(req: UpdateRequest) -> None:
        train_fn(req.entries, req.version)
    return typed


class SortedRLController(RolloutOrchestrator):
    """Paper §3.1/§3.3 strategy (shim; see module docstring)."""

    def __init__(self, engine: EngineProtocol, buffer: StatefulRolloutBuffer,
                 cfg: SortedRLConfig, train_fn: TrainFn,
                 metrics: Optional[RolloutMetrics] = None,
                 fill_policy: str = "resume_first"):
        super().__init__(engine, buffer, cfg,
                         SortedPolicy(fill_policy=fill_policy),
                         _wrap_legacy(train_fn), metrics)
        self.fill_policy = fill_policy


class CanonicalController(RolloutOrchestrator):
    """Wait-for-all baseline / post-hoc-sort ablation (shim)."""

    def __init__(self, engine: EngineProtocol, buffer: StatefulRolloutBuffer,
                 cfg: SortedRLConfig, train_fn: TrainFn,
                 metrics: Optional[RolloutMetrics] = None,
                 sort_post_hoc: bool = False, shuffle_seed: int = 0):
        policy = (PostHocSortPolicy(shuffle_seed=shuffle_seed)
                  if sort_post_hoc else
                  BaselinePolicy(shuffle_seed=shuffle_seed))
        super().__init__(engine, buffer, cfg, policy,
                         _wrap_legacy(train_fn), metrics)
        self.sort_post_hoc = sort_post_hoc


class UngroupedController(RolloutOrchestrator):
    """No-group-barrier ablation §4.4.2 (shim)."""

    def __init__(self, engine: EngineProtocol, buffer: StatefulRolloutBuffer,
                 cfg: SortedRLConfig, train_fn: TrainFn,
                 metrics: Optional[RolloutMetrics] = None,
                 prompt_stream=None, fill_policy: str = "resume_first"):
        super().__init__(engine, buffer, cfg,
                         UngroupedPolicy(prompt_stream=prompt_stream,
                                         fill_policy=fill_policy),
                         _wrap_legacy(train_fn), metrics)

    @property
    def prompt_stream(self):
        return self.policy.prompt_stream


class PipelinedController(RolloutOrchestrator):
    """Beyond-paper relaxed group barrier (shim)."""

    def __init__(self, engine: EngineProtocol, buffer: StatefulRolloutBuffer,
                 cfg: SortedRLConfig, train_fn: TrainFn,
                 metrics: Optional[RolloutMetrics] = None,
                 lookahead: int = 1):
        super().__init__(engine, buffer, cfg,
                         PipelinedPolicy(lookahead=lookahead),
                         _wrap_legacy(train_fn), metrics)

    def queue_group(self, prompts, metas=None) -> None:
        self.policy.queue_group(prompts, metas)
