"""Train, prefill and serve steps for one (architecture x shape) on one
card (counterpart of ``repro/launch/steps.py``).

``build_step`` returns a :class:`Built`: the step function and its
inputs as meta-device stand-ins (``in_specs``, the reference's
``ShapeDtypeStruct`` pytrees, of the unsharded tree), the activation
rules it installs and the model.  The reference also returns shardings
over its mesh; the port places nothing but the MoE family's experts, so
the plan acts only through ``remat``, ``microbatches`` and
``opt_dtype``.

The MoE family's train and prefill steps take the reference's
expert-parallel layer (``moe_mlp_ep``) when ``mesh`` is a ``DeviceMesh``,
as the reference does: every rank runs the whole step on the whole
batch, replicated, except inside the MoE layers, where each rank routes
its block of the tokens and runs its ``E_local`` experts.  Their
parameters (and moments) on a rank are then its slice
(``moe.shard_experts``), the grad norm the unsharded tree's
(``moe.ep_global_norm``).  The serve step stays on ``moe_mlp_dense``, as
the reference's does, and so does every step on a ``LocalMesh``: on one
device the expert-parallel layer is the same arithmetic.

The steps run on the device of the tensors they are given; the model is
built on the card unless the caller passes ``device="cpu"`` (or
``"meta"``, for shapes and operation counts only).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import axis_rules
from repro_torch.launch.mesh import is_device_mesh
from repro_torch.launch.plans import Plan, activation_rules
from repro_torch.models import model as model_lib
from repro_torch.models import moe as MOE
from repro_torch.rl.losses import LossConfig, total_loss
from repro_torch.rl.trainer import value_and_grad
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         tree_map)


@dataclasses.dataclass
class Built:
    """Everything dryrun/train needs for one combination."""
    fn: Any                     # the step function
    in_specs: Tuple             # meta tensors (positional)
    donate_argnums: Tuple[int, ...]   # arguments the step updates in place
    rules: Dict[str, Any]
    model: Any


def _round_len(n: int, align: int = 512) -> int:
    """Cache lengths rounded to a 512 multiple, as the reference's (there
    so that the sequence axis shards cleanly over its mesh)."""
    return -(-n // align) * align


def _batch_axes(multi_pod: bool, plan: Plan) -> Tuple[str, ...]:
    """The mesh axes the batch is split over (the reference's)."""
    axes = ("pod", "data") if multi_pod else ("data",)
    if plan.strategy == "dp":
        axes = axes + ("model",)
    return axes


def _ep_mesh(cfg: ModelConfig, mesh):
    """The mesh of the expert-parallel layer: ``mesh`` for the MoE family
    on a ``DeviceMesh``, else None (``moe_mlp_dense``)."""
    return mesh if cfg.family == "moe" and is_device_mesh(mesh) else None


def _meta_params(cfg: ModelConfig):
    """The parameter tree as meta tensors (the real init's shapes and
    dtypes, no storage)."""
    return model_lib.build_model(cfg, device=model_lib.META).init_params(
        torch.Generator())


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, plan: Plan,
                     mesh, multi_pod: bool, device=None) -> Built:
    """(params, opt_state, batch) -> (params, opt_state, metrics): the
    value and gradient of ``total_loss``, summed over ``plan.microbatches``
    slices of the batch and divided by their count (the loss the mean of
    the slices' losses), then AdamW with moments in ``plan.opt_dtype``.
    Parameters and moments are updated in place."""
    cfg = cfg.replace(remat=plan.remat)
    rules = activation_rules(plan, multi_pod, "train")
    ep_mesh = _ep_mesh(cfg, mesh)
    model = model_lib.build_model(cfg, device=device, ep_mesh=ep_mesh,
                                  data_axes=_batch_axes(multi_pod, plan))
    loss_cfg = LossConfig()
    opt_cfg = AdamWConfig(state_dtype=plan.opt_dtype)
    nmicro = plan.microbatches

    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            logits = logits[:, model.prefill_extra:]
        return total_loss(logits, aux, batch, loss_cfg)

    def train_step(params, opt_state, batch):
        with axis_rules(mesh, rules):
            if nmicro == 1:
                (loss, metrics), grads = value_and_grad(loss_fn, params,
                                                        batch)
                metrics = {k: v.detach() for k, v in metrics.items()}
            else:
                grads, loss = None, 0.0
                for i in range(nmicro):
                    mb = {k: v.reshape(nmicro, v.shape[0] // nmicro,
                                       *v.shape[1:])[i]
                          for k, v in batch.items()}
                    (l, _), g = value_and_grad(loss_fn, params, mb)
                    # summed in place: one gradient tree beside the
                    # slice's (the reference's adds, in the same dtype)
                    grads = g if grads is None else [
                        a.add_(b) for a, b in zip(grads, g)]
                    del g
                    loss = loss + l
                grads = [g.div_(nmicro) for g in grads]
                loss = loss / nmicro
                metrics = {}
            gnorm = (None if ep_mesh is None
                     else MOE.ep_global_norm(params, grads, ep_mesh))
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 opt_cfg, gnorm=gnorm)
            metrics.update(om)
            metrics["loss"] = loss
            return params, opt_state, metrics

    params_shape = _meta_params(cfg)

    def moments(p):
        return torch.empty(p.shape, dtype=plan.opt_dtype, device=p.device)
    opt_shape = OptState(
        step=torch.empty((), dtype=torch.int32, device=model_lib.META),
        m=tree_map(moments, params_shape), v=tree_map(moments, params_shape))
    batch_shape = model_lib.input_specs(cfg, shape.seq_len,
                                        shape.global_batch, "train")
    return Built(fn=train_step,
                 in_specs=(params_shape, opt_shape, batch_shape),
                 donate_argnums=(0, 1), rules=rules, model=model)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, plan: Plan,
                       mesh, multi_pod: bool, device=None) -> Built:
    """(params, batch, cache) -> (next token (B,) int32, cache).  The token
    is the argmax at column -1 of the logits, as in the reference: the
    padded width's last column, which is a row's prompt end only where
    the prompt fills the width (or the family pads on the left)."""
    cfg = cfg.replace(remat=False)
    rules = activation_rules(plan, multi_pod, "prefill")
    model = model_lib.build_model(cfg, device=device,
                                  ep_mesh=_ep_mesh(cfg, mesh),
                                  data_axes=_batch_axes(multi_pod, plan))
    max_len = _round_len(shape.seq_len + model.prefill_extra + 8)

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        with axis_rules(mesh, rules):
            logits, cache = model.prefill(params, batch, cache)
            last = logits[:, -1]
            return torch.argmax(last, dim=-1).to(torch.int32), cache

    batch_shape = model_lib.input_specs(cfg, shape.seq_len,
                                        shape.global_batch, "prefill")
    cache_shape = model_lib.cache_specs(cfg, shape.global_batch, max_len)
    return Built(fn=prefill_step,
                 in_specs=(_meta_params(cfg), batch_shape, cache_shape),
                 donate_argnums=(2,), rules=rules, model=model)


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig, plan: Plan,
                     mesh, multi_pod: bool, device=None) -> Built:
    """Decode: ONE new token against a seq_len KV cache.
    (params, token, cache, kv_len) -> (argmax of the f32 logits (B,)
    int32, its f32 log-softmax (B,), cache)."""
    cfg = cfg.replace(remat=False)
    rules = activation_rules(plan, multi_pod, "decode")
    # decode uses the dense-dispatch MoE layer, as the reference's does
    model = model_lib.build_model(cfg, device=device)
    max_len = _round_len(shape.seq_len + model.prefill_extra + 8)

    @torch.no_grad()
    def serve_step(params, token, cache, kv_len):
        with axis_rules(mesh, rules):
            logits, cache = model.decode_step(params, token, cache, kv_len)
            lf = logits.float()
            nxt = torch.argmax(lf, dim=-1)
            lp = torch.log_softmax(lf, dim=-1).gather(1, nxt[:, None])[:, 0]
            return nxt.to(torch.int32), lp, cache

    B = shape.global_batch
    step = model_lib.input_specs(cfg, shape.seq_len, B, "decode")
    cache_shape = model_lib.cache_specs(cfg, B, max_len)
    return Built(fn=serve_step,
                 in_specs=(_meta_params(cfg), step["token"], cache_shape,
                           step["kv_len"]),
                 donate_argnums=(2,), rules=rules, model=model)


def build_step(cfg: ModelConfig, shape: ShapeConfig, plan: Plan, mesh,
               multi_pod: bool, device=None) -> Built:
    if shape.kind == "train":
        return build_train_step(cfg, shape, plan, mesh, multi_pod, device)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, plan, mesh, multi_pod, device)
    return build_serve_step(cfg, shape, plan, mesh, multi_pod, device)
