"""Rollout buffer entry (copy of the reference's ``core/buffer.py`` entry
types).  The engine reads ``uid``, ``prompt`` and ``generated`` only, so
the reference's own entries work here too."""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Optional


class Mode(str, enum.Enum):
    ON_POLICY = "on_policy"   # discard partial generations; re-roll prompts
    PARTIAL = "partial"       # scavenge tokens + logprobs; resume generation


class EntryState(str, enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    CONSUMED = "consumed"


@dataclasses.dataclass
class BufferEntry:
    uid: int
    prompt: List[int]
    meta: Any = None                       # e.g. ground truth for the verifier
    generated: List[int] = dataclasses.field(default_factory=list)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    # policy version that generated each token — the off-policiness record
    versions: List[int] = dataclasses.field(default_factory=list)
    state: EntryState = EntryState.PENDING
    finish_reason: Optional[str] = None    # "eos" | "length"
    lifecycle: int = 0
    interruptions: int = 0

    @property
    def gen_len(self) -> int:
        return len(self.generated)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.generated)

    def staleness(self, current_version: int) -> float:
        """Mean number of policy updates between generation and now."""
        if not self.versions:
            return 0.0
        return sum(current_version - v for v in self.versions) / len(self.versions)
