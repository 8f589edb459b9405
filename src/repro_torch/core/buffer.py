"""Stateful rollout buffer (paper §3.3).

Each entry stores: the prompt context, the current partial trajectory, the
behaviour-policy log-probs for every generated token, a completion flag,
and a lifecycle indicator (the group epoch it was loaded in).  Entries are
resumed (partial mode) or re-rolled from the prompt (on-policy mode) after
early termination, and cleared once fed to the trainer.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Any, Dict, Iterable, List, Optional, Sequence


class Mode(str, enum.Enum):
    ON_POLICY = "on_policy"   # discard partial generations; re-roll prompts
    PARTIAL = "partial"       # scavenge tokens + logprobs; resume generation


class EntryState(str, enum.Enum):
    PENDING = "pending"       # waiting to be scheduled into the engine
    RUNNING = "running"       # currently occupies an engine slot
    DONE = "done"             # finished (eos / max len); awaiting training
    CONSUMED = "consumed"     # fed to the trainer; kept only for accounting


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
    lifecycle: int = 0                     # group epoch loaded in
    interruptions: int = 0                 # times scavenged

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


class StatefulRolloutBuffer:
    """Coordinates entry lifecycles across rollout iterations.

    Invariants (property-tested):
      * conservation — every loaded prompt is eventually consumed exactly once
      * partial mode — len(generated) == len(logprobs) == len(versions)
      * on-policy mode — after scavenging, generated/logprobs are empty
      * grouped loading — no entry of group g+1 exists while any entry of
        group g is not CONSUMED (enforced by the controller, checked here)
    """

    def __init__(self, mode: Mode = Mode.ON_POLICY):
        self.mode = Mode(mode)
        self.entries: Dict[int, BufferEntry] = {}
        self._uid = itertools.count()
        self.group_epoch = 0

    # -- loading ---------------------------------------------------------

    def load_prompts(self, prompts: Sequence[Sequence[int]],
                     metas: Optional[Sequence[Any]] = None) -> List[int]:
        if metas is None:
            metas = [None] * len(prompts)
        uids = []
        for prompt, meta in zip(prompts, metas):
            uid = next(self._uid)
            self.entries[uid] = BufferEntry(
                uid=uid, prompt=list(prompt), meta=meta,
                lifecycle=self.group_epoch)
            uids.append(uid)
        return uids

    # -- queries ---------------------------------------------------------

    def pending(self) -> List[BufferEntry]:
        return [e for e in self.entries.values()
                if e.state == EntryState.PENDING]

    def running(self) -> List[BufferEntry]:
        return [e for e in self.entries.values()
                if e.state == EntryState.RUNNING]

    def done(self) -> List[BufferEntry]:
        return [e for e in self.entries.values()
                if e.state == EntryState.DONE]

    def unconsumed(self) -> List[BufferEntry]:
        return [e for e in self.entries.values()
                if e.state != EntryState.CONSUMED]

    def group_clear(self) -> bool:
        """True when every loaded prompt has been fed to the trainer —
        the cache-aware loading condition for admitting the next group."""
        return not self.unconsumed()

    def current_group_clear(self) -> bool:
        """Pipelined variant: every entry of the *current* epoch consumed
        (next-epoch entries may already be in flight)."""
        return not any(e.lifecycle == self.group_epoch
                       for e in self.unconsumed())

    # -- pipelined (beyond-paper) loading ---------------------------------

    def load_prompts_next_group(self, prompts, metas=None):
        """Admit prompts belonging to the NEXT group epoch (lookahead=1)."""
        uids = self.load_prompts(prompts, metas)
        for uid in uids:
            self.entries[uid].lifecycle = self.group_epoch + 1
        return uids

    def group_epoch_load_allowed(self) -> bool:
        """Allow at most one group of lookahead."""
        return all(e.lifecycle <= self.group_epoch + 1
                   for e in self.unconsumed())

    # -- scheduling transitions -------------------------------------------

    def mark_running(self, uids: Iterable[int]) -> None:
        for uid in uids:
            e = self.entries[uid]
            assert e.state == EntryState.PENDING, (uid, e.state)
            e.state = EntryState.RUNNING

    def record_tokens(self, uid: int, tokens: Sequence[int],
                      logprobs: Sequence[float], version: int) -> None:
        e = self.entries[uid]
        assert e.state == EntryState.RUNNING
        e.generated.extend(int(t) for t in tokens)
        e.logprobs.extend(float(l) for l in logprobs)
        e.versions.extend([version] * len(tokens))

    def mark_done(self, uid: int, finish_reason: str) -> None:
        e = self.entries[uid]
        assert e.state == EntryState.RUNNING
        e.state = EntryState.DONE
        e.finish_reason = finish_reason

    def scavenge(self, uid: int) -> None:
        """Early termination hit this entry: return it to PENDING.

        on-policy: the partial generation is *discarded* — only the prompt
        is kept, to be re-rolled by the updated policy.
        partial  : generated tokens and their behaviour log-probs are kept;
        generation resumes from the prefix under the new policy, and the
        stitched log-probs serve as pi_old for importance sampling.
        """
        e = self.entries[uid]
        assert e.state == EntryState.RUNNING
        if self.mode == Mode.ON_POLICY:
            e.generated.clear()
            e.logprobs.clear()
            e.versions.clear()
        e.interruptions += 1
        e.state = EntryState.PENDING

    def consume(self, uids: Iterable[int]) -> List[BufferEntry]:
        out = []
        for uid in uids:
            e = self.entries[uid]
            assert e.state == EntryState.DONE, (uid, e.state)
            e.state = EntryState.CONSUMED
            out.append(e)
        return out

    def advance_group(self, strict: bool = True) -> None:
        if strict:
            assert self.group_clear(), "grouped loading: group not done"
        else:
            assert self.current_group_clear(), "pipelined: group not done"
        # drop consumed entries of the finished group to bound memory
        self.entries = {u: e for u, e in self.entries.items()
                        if e.state != EntryState.CONSUMED}
        self.group_epoch += 1

    # -- integrity ---------------------------------------------------------

    def check_invariants(self) -> None:
        for e in self.entries.values():
            assert len(e.generated) == len(e.logprobs) == len(e.versions), \
                f"uid={e.uid}: token/logprob/version misalignment"
            if e.state == EntryState.DONE:
                assert e.finish_reason in ("eos", "length"), e.finish_reason
            assert e.lifecycle <= self.group_epoch + 1  # +1: pipelined lookahead
