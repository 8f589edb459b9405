"""Knights & Knaves puzzle generator + rule-based verifier (LogicRL analog,
paper §4.1 / Xie et al. 2025).

Puzzles: n inhabitants, each a knight (truth-teller) or knave (liar); each
makes one statement; solvers must deduce every role.  We generate puzzles
with a *unique* solution (brute-force check over 2^n assignments) across a
difficulty mixture (3..7 characters), mirroring the LogicRL training mix.

Encoding (closed word-level language):
  prompt   = <bos> C0 says S0 <sep> C1 says S1 <sep> ... <ans>
  response = <think> ... free tokens ... <ans> r0 r1 ... r_{n-1} <eos>
where r_i in {knight, knave}.  The verifier scores:
  +0.2  format (an <ans> followed by exactly n role tokens then <eos>)
  +0.8 * (correct roles / n), +1.0 bonus if all correct
(a graded rule-based reward so a small from-scratch policy has signal).
"""
from __future__ import annotations

import dataclasses
import itertools
import random
from typing import List, Sequence, Tuple

from repro_torch.data.tokenizer import ANS, BOS, EOS, SEP, Vocab

NAMES = ["alice", "bob", "carol", "dave", "erin", "frank", "grace"]
ROLES = ["knight", "knave"]
WORDS = (NAMES + ROLES
         + ["says", "and", "or", "iff", "not", "is", "same", "diff"])

VOCAB = Vocab(WORDS)


# statements are closures over the hidden assignment ------------------------

@dataclasses.dataclass(frozen=True)
class Statement:
    kind: str          # "role" | "iff" | "or"
    a: int
    b: int = -1
    role: str = "knight"

    def eval(self, assign: Sequence[bool]) -> bool:
        if self.kind == "role":
            return assign[self.a] == (self.role == "knight")
        if self.kind == "iff":
            return assign[self.a] == assign[self.b]
        if self.kind == "or":
            return assign[self.a] or assign[self.b]
        raise ValueError(self.kind)

    def words(self) -> List[str]:
        if self.kind == "role":
            return [NAMES[self.a], "is", self.role]
        if self.kind == "iff":
            return [NAMES[self.a], "same", NAMES[self.b]]
        if self.kind == "or":
            return [NAMES[self.a], "or", NAMES[self.b], "is", "knight"]
        raise ValueError(self.kind)


@dataclasses.dataclass
class Puzzle:
    n: int
    statements: List[Statement]
    solution: Tuple[bool, ...]      # True = knight

    def consistent(self, assign: Sequence[bool]) -> bool:
        return all(st.eval(assign) == assign[i]
                   for i, st in enumerate(self.statements))

    def unique(self) -> bool:
        sols = [a for a in itertools.product([True, False], repeat=self.n)
                if self.consistent(a)]
        return len(sols) == 1 and tuple(sols[0]) == self.solution


def _random_statement(rng: random.Random, n: int, speaker: int,
                      assign: Sequence[bool]) -> Statement:
    others = [i for i in range(n) if i != speaker] or [speaker]
    kind = rng.choice(["role", "role", "iff", "or"])
    a = rng.choice(range(n))
    b = rng.choice(others)
    if kind == "role":
        st = Statement("role", a, role=rng.choice(ROLES))
    elif kind == "iff":
        st = Statement("iff", a, b)
    else:
        st = Statement("or", a, b)
    # knights speak truth, knaves lie: flip the statement if needed
    want = assign[speaker]
    if st.eval(assign) != want:
        if st.kind == "role":
            st = Statement("role", st.a,
                           role=("knave" if st.role == "knight" else "knight"))
        elif st.kind == "iff":
            # negate iff -> use role statement about a instead
            st = Statement("role", st.a,
                           role=("knight" if assign[st.a] == want else "knave"))
        else:
            st = Statement("role", st.a,
                           role=("knight" if assign[st.a] == want else "knave"))
    assert st.eval(assign) == want
    return st


def generate_puzzle(rng: random.Random, n: int,
                    max_tries: int = 200) -> Puzzle:
    for _ in range(max_tries):
        assign = tuple(rng.random() < 0.5 for _ in range(n))
        statements = [_random_statement(rng, n, i, assign) for i in range(n)]
        pz = Puzzle(n, statements, assign)
        if pz.unique():
            return pz
    # fall back: accept consistent-but-maybe-ambiguous (rare)
    return pz


def encode_prompt(pz: Puzzle, vocab: Vocab = VOCAB) -> List[int]:
    words = [BOS]
    for i, st in enumerate(pz.statements):
        words += [NAMES[i], "says"] + st.words()
        words.append(SEP)
    words.append(ANS)
    return vocab.encode(words)


def solution_words(pz: Puzzle) -> List[str]:
    return [ROLES[0] if k else ROLES[1] for k in pz.solution]


def encode_solution(pz: Puzzle, vocab: Vocab = VOCAB) -> List[int]:
    return vocab.encode(solution_words(pz) + [EOS])


@dataclasses.dataclass
class LogicMeta:
    solution: Tuple[bool, ...]
    n: int
    prompt_id: int = 0


def verify(generated: Sequence[int], meta: LogicMeta,
           vocab: Vocab = VOCAB) -> float:
    """Rule-based graded reward (see module docstring)."""
    words = vocab.decode(generated)
    n = meta.n
    # find the final answer segment: last n role tokens before <eos>
    if EOS in words:
        words = words[:words.index(EOS)]
        has_eos = True
    else:
        has_eos = False
    roles = [w for w in words if w in ROLES]
    answer = roles[-n:] if len(roles) >= n else roles
    reward = 0.0
    if has_eos and len(roles) >= n and all(
            w in ROLES for w in words[-n:] if words):
        reward += 0.2                      # format
    if answer:
        truth = [ROLES[0] if k else ROLES[1] for k in meta.solution]
        correct = sum(a == t for a, t in zip(answer, truth[:len(answer)]))
        reward += 0.8 * correct / n
        if len(answer) == n and correct == n and has_eos:
            reward += 1.0                  # exact solve bonus
    return reward


class LogicTaskGenerator:
    """Difficulty-mixed stream of (prompt_tokens, meta), LogicRL style."""

    def __init__(self, min_chars: int = 3, max_chars: int = 5, seed: int = 0):
        self.rng = random.Random(seed)
        self.min_chars = min_chars
        self.max_chars = max_chars
        self._pid = 0

    def sample(self) -> Tuple[List[int], LogicMeta]:
        n = self.rng.randint(self.min_chars, self.max_chars)
        pz = generate_puzzle(self.rng, n)
        meta = LogicMeta(solution=pz.solution, n=n, prompt_id=self._pid)
        self._pid += 1
        return encode_prompt(pz), meta

    def batch(self, k: int):
        pairs = [self.sample() for _ in range(k)]
        return [p for p, _ in pairs], [m for _, m in pairs]

    def sft_example(self) -> Tuple[List[int], List[int]]:
        """(prompt, target) pair for supervised warm-up (the paper starts
        from instruct models; warm-up plays that role at toy scale)."""
        prompt, meta = self.sample()
        pz_sol = [ROLES[0] if k else ROLES[1] for k in meta.solution]
        return prompt, VOCAB.encode(pz_sol + [EOS])
