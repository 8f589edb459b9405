"""AdamW from scratch (counterpart of ``repro/train/optimizer.py``; no
``torch.optim``), with configurable state dtype and global-norm gradient
clipping.

The arithmetic is the reference's, step for step: moments in
``state_dtype``, the clip factor ``clip / (gnorm + 1e-9)``, bias
corrections ``1 - b ** step`` on f32 tensors, the new parameter computed
in f32 and cast to the parameter's dtype.  One difference of form: the
reference builds a new tree, this version writes the same values into
the existing parameter and moment tensors (under ``torch.no_grad()``),
so an engine whose ``params_fn`` returns those tensors reads the new
weights without a copy or a re-binding.

Trees are nested dicts of tensors; leaves are visited in the reference's
order (``jax.tree.leaves`` sorts dict keys), which fixes the order of the
global norm's sum.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32   # bf16 for the huge configs
    warmup_steps: int = 0
    total_steps: int = 0               # 0: constant lr after warmup


class OptState(NamedTuple):
    step: torch.Tensor                 # () int32
    m: Any
    v: Any


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of nested dicts and lists in ``jax.tree.leaves`` order
    (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def init_opt_state(params: Any, cfg: AdamWConfig) -> OptState:
    def zeros(p):
        return torch.zeros_like(p, dtype=cfg.state_dtype)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    lr = torch.tensor(cfg.lr, dtype=torch.float32, device=step.device)
    if cfg.warmup_steps:
        lr = lr * torch.clamp((step + 1) / cfg.warmup_steps, max=1.0)
    if cfg.total_steps:
        frac = torch.clamp((step - cfg.warmup_steps)
                           / max(1, cfg.total_steps - cfg.warmup_steps),
                           0, 1)
        lr = lr * 0.5 * (1 + torch.cos(math.pi * frac))
    return lr


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: OptState, cfg: AdamWConfig
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  ``grads`` is a tree shaped like ``params``, or the
    list of its leaves in ``tree_leaves`` order.  Parameters and moments
    are updated in place; returns (params, new state, {"grad_norm",
    "lr"})."""
    flat_g = tree_leaves(grads)
    gnorm = global_norm(flat_g)
    scale = (torch.where(gnorm > cfg.grad_clip,
                         cfg.grad_clip / (gnorm + 1e-9),
                         torch.ones_like(gnorm))
             if cfg.grad_clip else 1.0)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    for p, g, m, v in zip(tree_leaves(params), flat_g,
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * torch.square(g)
        mh = m32 / b1c
        vh = v32 / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    return params, OptState(step, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
