"""RL trainer (counterpart of ``repro/rl/trainer.py``): converts finished
BufferEntries into padded update batches and runs the policy-gradient
step.

The importance-sampling denominators come straight from the buffer's
cached per-token behaviour log-probs, the stitched pi_old of partial mode
(paper §3.2).

The step differentiates the model's plain ``forward`` (plain attention,
no kernel) with ``torch.autograd``, as the reference differentiates its
jnp forward with ``jax.value_and_grad``.  Parameters never require grad
outside the step: the gradient is taken over detached leaves that share
the parameters' storage, and AdamW then writes the new values into the
parameters in place, so the rollout engine's ``params_fn`` (this
trainer's ``params``) reads them with no copy.

The batch is built on the model's device and ends, as the reference's
does, in ``shard_update_batch`` (:mod:`repro_torch.distributed.sharding`):
the identity outside an ``axis_rules`` context, and inside one a padding
to the data shards' count with inert rows; on a ``DeviceMesh`` each rank
then keeps its slice of the rows and the update runs data-parallel: the
loss's masked means take the whole batch's token count, the gradients
are summed over the batch's axes in rank order and the parameters end
the same bits on every rank (``make_train_step``).  The MoE family's
routers take the whole batch's capacity, drops and aux losses there, as
the reference's (``models/moe.py`` ``moe_mlp_dense``).
The Trainer protocol (``make_trainer`` etc.) is re-exported from
:mod:`repro_torch.rl.trainer_api`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.buffer import BufferEntry
from repro_torch.core.orchestrator import UpdateRequest, UpdateResult
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import shard_update_batch
from repro_torch.models.model import Model
from repro_torch.rl import advantages as A
from repro_torch.rl.losses import LossConfig, total_loss
# the typed trainer front (protocol + registry + callable shim) lives in
# the trainer_api module; re-exported here as the public surface
from repro_torch.rl.trainer_api import (CostSpec, StreamingTrainer,  # noqa: F401
                                        SyncTrainer, TrainOutcome, Trainer,
                                        as_trainer, available_trainers,
                                        make_trainer, register_trainer)
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         init_opt_state, tree_leaves,
                                         tree_map)


@dataclasses.dataclass
class TrainState:
    params: Dict
    opt_state: OptState
    step: int = 0


RewardFn = Callable[[Sequence[int], object], float]


def entries_to_batch(entries: Sequence[BufferEntry], reward_fn: RewardFn,
                     pad_id: int, max_len: int,
                     advantage_kind: str = "reinforce_pp", *,
                     current_version: Optional[int] = None, device=None,
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, float]]:
    """Pad trajectories to a common width and build the update batch on
    ``device`` (the card unless the caller passes ``device="cpu"``).

    tokens = [prompt, generated]; loss_mask covers generated tokens;
    old_logprobs are the buffer's cached behaviour log-probs.  Staleness
    is measured against ``current_version``, the trainer's policy version
    at update time; entries whose prompt leaves no room for generated
    tokens are skipped with a warning (they would train on an all-zero
    loss mask).  On a ``DeviceMesh`` each rank keeps its slice of the
    padded rows (``shard_update_batch``).
    """
    dev = resolve_device(device)
    kept, skipped = [], []
    for e in entries:
        (kept if len(e.prompt) < max_len else skipped).append(e)
    if skipped:
        warnings.warn(
            f"entries_to_batch: skipping {len(skipped)} "
            f"entr{'y' if len(skipped) == 1 else 'ies'} with prompt >= "
            f"max_len={max_len} (uids {[e.uid for e in skipped[:8]]}); "
            f"no generated token fits the update window")
    if not kept:
        raise ValueError(
            f"entries_to_batch: all {len(entries)} entries were skipped "
            f"(every prompt >= max_len={max_len})")
    if current_version is None:
        # fallback: newest version seen in the batch (lower bound)
        current_version = max((max(e.versions) for e in kept if e.versions),
                              default=0)
    B = len(kept)
    width = max(e.total_len for e in kept)
    width = min(max_len, (width + 31) // 32 * 32)   # bucket: few shapes
    tokens = np.full((B, width), pad_id, np.int32)
    loss_mask = np.zeros((B, width), np.float32)
    old_lp = np.zeros((B, width), np.float32)
    rewards = np.zeros(B, np.float32)
    staleness = np.zeros(B, np.float32)
    group_ids = np.zeros(B, np.int32)
    # dense group indices: responses sharing a prompt_id form one GRPO
    # group; unrelated prompts never collide
    gid_of: Dict = {}
    for i, e in enumerate(kept):
        seq = (list(e.prompt) + list(e.generated))[:width]
        tokens[i, :len(seq)] = seq
        p = min(len(e.prompt), width)
        g = len(seq) - p
        loss_mask[i, p:p + g] = 1.0
        old_lp[i, p:p + g] = e.logprobs[:g]
        rewards[i] = reward_fn(e.generated, e.meta)
        staleness[i] = e.staleness(current_version)
        pid = getattr(e.meta, "prompt_id", None)
        key = pid if pid is not None else ("uid", e.uid)
        group_ids[i] = gid_of.setdefault(key, len(gid_of))
    assert float(loss_mask.sum()) > 0, \
        "update batch has no trainable tokens (all-zero loss mask)"
    lm = torch.from_numpy(loss_mask).to(dev)
    r = torch.from_numpy(rewards).to(dev)
    if advantage_kind == "reinforce_pp":
        adv = A.reinforce_pp(r, lm)
    elif advantage_kind == "grpo":
        adv = A.grpo(r, torch.from_numpy(group_ids).to(dev), lm,
                     num_groups=int(group_ids.max()) + 1)
    else:
        raise ValueError(advantage_kind)
    batch = {
        "tokens": torch.from_numpy(tokens).to(dev),
        "loss_mask": lm,
        "advantages": adv,
        "old_logprobs": torch.from_numpy(old_lp).to(dev),
    }
    # identity outside an axis_rules context; inside one, inert pad rows
    # up to the data shards' count (after the advantages, as the reference)
    batch = shard_update_batch(batch, pad_token=pad_id)
    info = {
        "reward_mean": float(rewards.mean()),
        "reward_std": float(rewards.std()),
        "gen_len_mean": float(np.mean([e.gen_len for e in kept])),
        "solve_rate": float(np.mean(rewards >= 1.2)),
        "staleness_mean": float(staleness.mean()),
        "staleness_max": float(staleness.max()),
        "entries_skipped": float(len(skipped)),
    }
    return batch, info


def value_and_grad(fn: Callable[..., Tuple[torch.Tensor, Any]], params: Any,
                   *args) -> Tuple[Tuple[torch.Tensor, Any],
                                   List[torch.Tensor]]:
    """``fn(params, *args) -> (loss, aux)`` and d loss / d params, as the
    list of gradients in ``tree_leaves`` order.  The gradient is taken
    over detached leaves that share the parameters' storage, so the
    parameters themselves never require grad and no graph outlives the
    call."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, aux = fn(live, *args)
        grads = torch.autograd.grad(loss, tree_leaves(live))
    return (loss.detach(), aux), list(grads)


def make_train_step(model: Model, loss_cfg: LossConfig, opt_cfg: AdamWConfig):
    """Returns (params, opt_state, batch) -> (params, opt_state, metrics):
    the loss on ``model.forward``, its gradient through autograd, then
    AdamW in place; data-parallel under ``axis_rules`` on a
    ``DeviceMesh`` (the rank's rows of the batch, the module docstring).  A vision-language batch with
    ``patch_embeds`` scores only its token positions, as the reference's
    does; ``entries_to_batch`` builds none, so the trainer scores the
    tokens without the stub rows the engine served them after (the
    reference's behaviour, kept)."""


    def loss_fn(params, batch, den):
        logits, aux = model.forward(params, batch)
        if model.cfg.family == "vlm" and "patch_embeds" in batch:
            logits = logits[:, model.prefill_extra:]
        return total_loss(logits, aux, batch, loss_cfg, den=den)

    def train_step(params, opt_state, batch):
        placement = SH.update_placement()
        if placement is None:
            return step(params, opt_state, batch, None)
        mesh, rules, _ = SH._current()
        with SH.axis_rules(mesh, rules, placement):
            den = torch.clamp(SH.sum_batch(batch["loss_mask"].sum()),
                              min=1.0)
            return step(params, opt_state, batch, den)

    def step(params, opt_state, batch, den):
        (_, metrics), grads = value_and_grad(loss_fn, params, batch, den)
        metrics = {k: SH.sum_batch(v.detach()) for k, v in metrics.items()}
        grads = SH.sync_grads(grads, None)
        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


class RLTrainer:
    """Host-side wrapper the controller's train_fn hooks into."""

    def __init__(self, model: Model, params, reward_fn: RewardFn,
                 loss_cfg: Optional[LossConfig] = None,
                 opt_cfg: Optional[AdamWConfig] = None,
                 pad_id: int = 0, max_len: int = 512,
                 advantage_kind: str = "reinforce_pp",
                 responses_per_prompt: int = 1):
        # responses_per_prompt is accepted for signature compatibility and
        # run metadata; GRPO grouping is keyed on meta.prompt_id
        self.model = model
        self.loss_cfg = loss_cfg or LossConfig()
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.state = TrainState(params, init_opt_state(params, self.opt_cfg))
        self.reward_fn = reward_fn
        self.pad_id = pad_id
        self.max_len = max_len
        self.advantage_kind = advantage_kind
        self.responses_per_prompt = responses_per_prompt
        self._step = make_train_step(model, self.loss_cfg, self.opt_cfg)
        self.history: List[Dict] = []

    def params(self):
        return self.state.params

    def update(self, entries: List[BufferEntry], version: int) -> Dict:
        batch, info = entries_to_batch(
            entries, self.reward_fn, self.pad_id, self.max_len,
            self.advantage_kind, current_version=version,
            device=self.model.device)
        params, opt_state, metrics = self._step(
            self.state.params, self.state.opt_state, batch)
        self.state = TrainState(params, opt_state, self.state.step + 1)
        rec = {k: float(v) for k, v in metrics.items()}
        rec.update(info)
        rec["version"] = version
        rec["step"] = self.state.step
        self.history.append(rec)
        return rec

    def handle(self, request: UpdateRequest) -> UpdateResult:
        """Typed orchestrator entry point (UpdateRequest -> UpdateResult)."""
        rec = self.update(request.entries, request.version)
        return UpdateResult(metrics=rec)
