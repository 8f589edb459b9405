"""Policy-gradient losses (counterpart of ``repro/rl/losses.py``; paper
Eq. 1) with the DAPO tricks used in §4.1: clip-higher (asymmetric
clipping range), no KL term, no entropy bonus.

The importance ratio uses *cached behaviour log-probs* (pi_old), in
partial mode stitched across policy versions per token (§3.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class LossConfig:
    clip_eps_low: float = 0.2
    clip_eps_high: float = 0.28      # DAPO clip-higher
    kl_coef: float = 0.0             # removed per §4.1
    entropy_coef: float = 0.0        # removed per §4.1
    aux_load_balance: float = 1e-2   # MoE router losses
    aux_router_z: float = 1e-3
    value_coef: float = 0.5          # PPO critic loss weight


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """logits: (B, S, V) predicting token t+1 at position t.
    Returns log pi(tokens[t] | <t) aligned to positions (B, S): entry t is
    the log-prob OF token t (from logits at t-1); entry 0 is 0.  The
    log-softmax runs in f32 over the whole vocabulary."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp_next = torch.gather(lp[:, :-1], 2,
                           tokens[:, 1:, None].long())[..., 0]   # (B, S-1)
    return torch.nn.functional.pad(lp_next, (1, 0))


def ppo_clip_loss(new_logprobs: torch.Tensor, old_logprobs: torch.Tensor,
                  advantages: torch.Tensor, loss_mask: torch.Tensor,
                  cfg: LossConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Eq. 1 with clip-higher.  All inputs (B, S); mask selects generated
    tokens.  Returns (scalar loss, metrics)."""
    ratio = torch.exp(new_logprobs - old_logprobs)
    unclipped = ratio * advantages
    clipped = torch.clamp(ratio, 1.0 - cfg.clip_eps_low,
                          1.0 + cfg.clip_eps_high) * advantages
    obj = torch.minimum(unclipped, clipped)
    n = torch.clamp(loss_mask.sum(), min=1.0)
    loss = -(obj * loss_mask).sum() / n
    clip_frac = ((torch.abs(ratio - 1.0) > cfg.clip_eps_low)
                 * loss_mask).sum() / n
    metrics = {
        "policy_loss": loss,
        "ratio_mean": (ratio * loss_mask).sum() / n,
        "clip_frac": clip_frac,
        "kl_to_old": ((old_logprobs - new_logprobs) * loss_mask).sum() / n,
    }
    return loss, metrics


def value_loss(values: torch.Tensor, returns: torch.Tensor,
               loss_mask: torch.Tensor) -> torch.Tensor:
    n = torch.clamp(loss_mask.sum(), min=1.0)
    return 0.5 * (torch.square(values - returns) * loss_mask).sum() / n


def total_loss(logits: torch.Tensor, aux: Dict[str, torch.Tensor],
               batch: Dict[str, torch.Tensor], cfg: LossConfig,
               values: Optional[torch.Tensor] = None,
               returns: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: tokens (B,S), loss_mask (B,S), advantages (B,S),
    old_logprobs (B,S)."""
    new_lp = token_logprobs(logits, batch["tokens"])
    loss, metrics = ppo_clip_loss(new_lp, batch["old_logprobs"],
                                  batch["advantages"], batch["loss_mask"],
                                  cfg)
    if cfg.entropy_coef:
        p = torch.softmax(logits.float(), dim=-1)
        ent = -(p * torch.log(p + 1e-9)).sum(-1)
        n = torch.clamp(batch["loss_mask"].sum(), min=1.0)
        ent_mean = (ent * batch["loss_mask"]).sum() / n
        loss = loss - cfg.entropy_coef * ent_mean
        metrics["entropy"] = ent_mean
    if values is not None and returns is not None:
        vl = value_loss(values, returns, batch["loss_mask"])
        loss = loss + cfg.value_coef * vl
        metrics["value_loss"] = vl
    loss = (loss + cfg.aux_load_balance * aux.get("load_balance", 0.0)
            + cfg.aux_router_z * aux.get("router_z", 0.0))
    metrics["total_loss"] = loss
    return loss, metrics
