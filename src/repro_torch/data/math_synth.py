"""Synthetic integer-answer math tasks (DAPO-Math-17k analog, §4.1).

Problems are modular-arithmetic expressions with a single integer answer,
verified by exact match — the same rule-based verification contract as the
paper's transformed AoPS problems.  Difficulty scales with expression depth
(more operands -> longer reasoning -> longer responses), giving the
length/difficulty correlation the micro-curriculum relies on.
"""
from __future__ import annotations

import dataclasses
import random
from typing import List, Sequence, Tuple

from repro_torch.data.tokenizer import ANS, BOS, EOS, Vocab

DIGITS = [str(d) for d in range(10)]
WORDS = DIGITS + ["+", "-", "*", "mod", "(", ")", "="]
MATH_VOCAB = Vocab(WORDS)


@dataclasses.dataclass
class MathMeta:
    answer: int
    depth: int
    prompt_id: int = 0


def _expr(rng: random.Random, depth: int) -> Tuple[List[str], int]:
    if depth == 0:
        v = rng.randint(0, 9)
        return [str(v)], v
    op = rng.choice(["+", "-", "*"])
    lw, lv = _expr(rng, depth - 1)
    rw, rv = _expr(rng, rng.randint(0, depth - 1))
    val = {"+": lv + rv, "-": lv - rv, "*": lv * rv}[op]
    return ["("] + lw + [op] + rw + [")"], val


def generate(rng: random.Random, depth: int) -> Tuple[List[int], MathMeta]:
    words, val = _expr(rng, depth)
    ans = val % 10
    prompt = [BOS] + words + ["mod", "1", "0", "=", ANS]
    return MATH_VOCAB.encode(prompt), MathMeta(answer=ans, depth=depth)


def verify(generated: Sequence[int], meta: MathMeta,
           vocab: Vocab = MATH_VOCAB) -> float:
    words = vocab.decode(generated)
    if EOS in words:
        words = words[:words.index(EOS)]
        has_eos = True
    else:
        has_eos = False
    digits = [w for w in words if w in DIGITS]
    reward = 0.0
    if has_eos and digits:
        reward += 0.2
        if digits[-1] == str(meta.answer):
            reward += 1.0
    return reward


class MathTaskGenerator:
    def __init__(self, min_depth: int = 1, max_depth: int = 3, seed: int = 0):
        self.rng = random.Random(seed)
        self.min_depth = min_depth
        self.max_depth = max_depth
        self._pid = 0

    def sample(self):
        d = self.rng.randint(self.min_depth, self.max_depth)
        toks, meta = generate(self.rng, d)
        meta.prompt_id = self._pid
        self._pid += 1
        return toks, meta

    def batch(self, k: int):
        pairs = [self.sample() for _ in range(k)]
        return [p for p, _ in pairs], [m for _, m in pairs]

    def sft_example(self):
        toks, meta = self.sample()
        return toks, MATH_VOCAB.encode([str(meta.answer), EOS])
