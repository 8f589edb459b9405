"""Grouped dataloader: feeds the controller group-sized prompt batches
(the n*b "grouped loading" unit of paper §3.1) from any task generator,
with responses-per-prompt duplication and epoch accounting.
"""
from __future__ import annotations

from typing import Any, Iterator, List, Protocol, Tuple


class TaskGenerator(Protocol):
    def batch(self, k: int) -> Tuple[List[List[int]], List[Any]]: ...


class GroupedLoader:
    def __init__(self, gen: TaskGenerator, rollout_batch: int,
                 group_size: int, responses_per_prompt: int = 1):
        self.gen = gen
        self.rollout_batch = rollout_batch
        self.group_size = group_size
        self.k = max(1, responses_per_prompt)
        self.groups_served = 0

    @property
    def prompts_per_group(self) -> int:
        return self.rollout_batch * self.group_size

    def next_group(self) -> Tuple[List[List[int]], List[Any]]:
        """One group of n*b trajectories (n*b/k distinct prompts, each
        duplicated k times for multi-response advantages)."""
        n_unique = self.prompts_per_group // self.k
        prompts, metas = self.gen.batch(n_unique)
        out_p = [list(p) for p in prompts for _ in range(self.k)]
        out_m = [m for m in metas for _ in range(self.k)]
        self.groups_served += 1
        return out_p, out_m

    def stream(self) -> Iterator[Tuple[List[int], Any]]:
        """Ungrouped prompt stream (for the no-grouping ablation)."""
        while True:
            p, m = self.gen.batch(1)
            yield list(p[0]), m[0]
