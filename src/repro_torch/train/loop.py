"""End-to-end RL loop (counterpart of ``repro/train/loop.py``): thin
wrappers mapping the historical :class:`RLExperimentConfig` onto a
:class:`~repro_torch.rl.session.SessionConfig`.  ``tiny_lm_config``,
``sft_warmup`` and ``evaluate`` are re-exported for existing imports.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.buffer import Mode
from repro_torch.rl.session import (RLSession, SessionConfig,  # noqa: F401
                                    evaluate, sft_warmup, tiny_lm_config)

__all__ = ["RLExperimentConfig", "run_logic_rl", "run_math_rl",
           "tiny_lm_config", "sft_warmup", "evaluate"]


@dataclasses.dataclass
class RLExperimentConfig:
    strategy: str = "sorted"          # any repro_torch.core.policy name
    mode: Mode = Mode.ON_POLICY
    rollout_batch: int = 32           # engine capacity (slots)
    group_size: int = 2
    update_batch: int = 32
    max_gen_len: int = 24
    max_total_len: int = 160
    n_groups: int = 4
    sft_steps: int = 150
    lr: float = 3e-4
    temperature: float = 1.0
    seed: int = 0
    d_model: int = 128
    layers: int = 4
    eval_every: int = 4               # updates between evals
    eval_size: int = 64
    # paper LogicRL setting: k responses per prompt (duplicated entries
    # sharing prompt_id -> grpo groups or reinforce++ batch stats)
    responses_per_prompt: int = 1
    advantage_kind: str = "reinforce_pp"   # reinforce_pp | grpo
    device: Optional[str] = None      # None: the card


def _session_config(cfg: RLExperimentConfig, task: str) -> SessionConfig:
    return SessionConfig(
        task=task, policy=cfg.strategy, mode=cfg.mode,
        rollout_batch=cfg.rollout_batch, group_size=cfg.group_size,
        update_batch=cfg.update_batch, max_gen_len=cfg.max_gen_len,
        max_total_len=cfg.max_total_len, n_groups=cfg.n_groups,
        sft_steps=cfg.sft_steps, lr=cfg.lr, temperature=cfg.temperature,
        seed=cfg.seed, d_model=cfg.d_model, layers=cfg.layers,
        eval_every=cfg.eval_every, eval_size=cfg.eval_size,
        responses_per_prompt=cfg.responses_per_prompt,
        advantage_kind=cfg.advantage_kind, device=cfg.device)


def run_logic_rl(cfg: RLExperimentConfig) -> Dict:
    """Paper §4.2 analog (Knights & Knaves) under any registered policy."""
    return RLSession.from_config(_session_config(cfg, "logic")).run()


def run_math_rl(cfg: RLExperimentConfig) -> Dict:
    """Paper §4.3 analog (integer-answer math) under any registered
    policy."""
    return RLSession.from_config(_session_config(cfg, "math")).run()
