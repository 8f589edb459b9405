"""Minimal word-level tokenizer for the synthetic RL tasks.

The paper trains on text datasets with a production tokenizer; our CPU-scale
end-to-end runs use closed synthetic languages (Knights & Knaves, integer
math), so a fixed word-level vocabulary is exact and dependency-free.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

PAD, BOS, EOS, SEP, ANS, THINK = "<pad>", "<bos>", "<eos>", "<sep>", "<ans>", "<think>"
SPECIALS = [PAD, BOS, EOS, SEP, ANS, THINK]


class Vocab:
    def __init__(self, words: Sequence[str]):
        self.itos: List[str] = list(SPECIALS) + [w for w in words
                                                 if w not in SPECIALS]
        self.stoi: Dict[str, int] = {w: i for i, w in enumerate(self.itos)}
        assert len(self.stoi) == len(self.itos), "duplicate words"

    def __len__(self) -> int:
        return len(self.itos)

    @property
    def pad_id(self) -> int:
        return self.stoi[PAD]

    @property
    def bos_id(self) -> int:
        return self.stoi[BOS]

    @property
    def eos_id(self) -> int:
        return self.stoi[EOS]

    def encode(self, words: Sequence[str]) -> List[int]:
        return [self.stoi[w] for w in words]

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.itos[int(i)] for i in ids]
