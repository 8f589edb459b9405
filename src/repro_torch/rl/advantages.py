"""Advantage estimators (counterpart of ``repro/rl/advantages.py``; paper
§2.1, Eqs. 2-3).

* Reinforce++ (Eq. 3): batch-normalised terminal reward.
* GRPO-style group normalisation (per-prompt groups).
* PPO GAE (Eq. 2) with a value head.

All take and return float tensors on the caller's device.
"""
from __future__ import annotations

import torch


def reinforce_pp(rewards: torch.Tensor, loss_mask: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """rewards: (B,) terminal rewards; loss_mask: (B, S) 1.0 on generated
    tokens.  Returns per-token advantages (B, S): every generated token of
    trajectory i gets (R_i - mu_batch) / sigma_batch (population std)."""
    mu = torch.mean(rewards)
    sigma = torch.sqrt(torch.mean(torch.square(rewards - mu)))  # jnp.std
    adv = (rewards - mu) / (sigma + eps)
    return adv[:, None] * loss_mask


def grpo(rewards: torch.Tensor, group_ids: torch.Tensor,
         loss_mask: torch.Tensor, num_groups: int,
         eps: float = 1e-6) -> torch.Tensor:
    """Group-relative normalisation: per-prompt groups of k samples."""
    onehot = torch.nn.functional.one_hot(group_ids.long(), num_groups).to(
        rewards.dtype)                                          # (B, G)
    counts = torch.clamp(onehot.sum(0), min=1.0)                # (G,)
    mu_g = (onehot * rewards[:, None]).sum(0) / counts
    var_g = (onehot * torch.square(rewards[:, None] - mu_g[None])).sum(0) \
        / counts
    adv = (rewards - onehot @ mu_g) / (torch.sqrt(onehot @ var_g) + eps)
    return adv[:, None] * loss_mask


def gae(rewards_t: torch.Tensor, values: torch.Tensor,
        loss_mask: torch.Tensor, gamma: float = 1.0,
        lam: float = 0.95) -> torch.Tensor:
    """PPO GAE (Eq. 2).  rewards_t: (B, S) per-token rewards (usually the
    terminal reward at the last generated token); values: (B, S+1) value
    predictions (bootstrap column appended).  Returns advantages (B, S).
    The recursion runs right to left over S, as the reference's scan."""
    B, S = rewards_t.shape
    deltas = rewards_t + gamma * values[:, 1:] * loss_mask - values[:, :-1]
    carry = torch.zeros(B, dtype=deltas.dtype, device=deltas.device)
    adv = torch.empty_like(deltas)
    for t in range(S - 1, -1, -1):
        carry = deltas[:, t] + gamma * lam * loss_mask[:, t] * carry
        adv[:, t] = carry
    return adv * loss_mask


def whiten(adv: torch.Tensor, loss_mask: torch.Tensor,
           eps: float = 1e-6) -> torch.Tensor:
    """Masked whitening over the batch (token level)."""
    n = torch.clamp(loss_mask.sum(), min=1.0)
    mu = (adv * loss_mask).sum() / n
    var = (torch.square(adv - mu) * loss_mask).sum() / n
    return (adv - mu) * torch.rsqrt(var + eps) * loss_mask
