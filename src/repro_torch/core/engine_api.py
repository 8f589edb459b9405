"""Engine protocol types (copy of the reference's ``core/engine_api.py``:
``StepEvent``, ``SlotTable``, ``EngineProtocol``).

The controller only speaks this interface; the port's ``SlotEngine``
satisfies it, and the optional migration capability
(``export_entry``/``import_entry``/``discard_entry``) and ``shutdown()``
keep the reference's duck-typed shapes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.buffer import BufferEntry


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

    All mutators take index *arrays*, so an engine can retire or advance
    every slot of a step in a handful of numpy ops instead of a per-slot
    Python loop.  Engines emit StepEvents in ascending slot order.
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
    def clock(self) -> float:
        ...

    def free_slots(self) -> int: ...

    def active_uids(self) -> List[int]: ...

    def submit(self, entries: Sequence[BufferEntry], version: int) -> None:
        ...

    def step(self) -> List[StepEvent]:
        ...

    def interrupt(self, uids: Optional[Sequence[int]] = None) -> List[int]:
        ...

    def sync_weights(self, version: int) -> None:
        ...
