"""Train, prefill and serve steps for one (architecture x shape x mesh)
(counterpart of ``repro/launch/steps.py``).

``build_step`` returns a :class:`Built`: the step function, its inputs
as meta-device stand-ins of the whole tree (``in_specs``, the
reference's ``ShapeDtypeStruct`` pytrees), the placements of its inputs
and outputs (``in_shardings``, ``out_shardings``: trees of spec tuples,
``launch/plans.py``; the reference's ``NamedSharding`` trees), the
activation rules it installs, the mesh and the model.

The dense and MoE families on a ``DeviceMesh`` run placed: each rank
holds the blocks the specs give it at its mesh coordinates
(``plans.place`` of the whole trees; ``plans.gather`` brings them back)
and computes on them, one program a rank, as the reference's steps
compute on each device under their shardings:

* ``dp``: the batch rows over the fitted batch axes (``_batch_spec``),
  parameters replicated; each rank's loss is its rows' part of the
  whole batch's (the masked means' token count is the whole batch's,
  per the reference's microbatch), gradients summed over the batch axes.
* ``tp``: Megatron tensor parallelism over ``model`` (the rank's heads,
  FFN columns and vocabulary rows), FSDP over ``data`` (a weight's FSDP
  dim gathered where a layer uses it, its gradient reduce-scattered),
  the batch over ``data``, and under train the sequence-parallel
  residual (``"seq" -> "model"``).
* the MoE family's train and prefill steps take the reference's
  expert-parallel layer (``moe.moe_mlp_ep``) on the placed residual: its
  ``shard_map`` block is the rank's rows and, under sequence
  parallelism, its block of the sequence; the experts are split over
  ``model`` where 16 divides them (else every rank holds them all and
  runs its ``E_local``) and FSDP over ``data``.  Its serve step takes the
  dense-dispatch layer (``moe.moe_mlp_dense``), as the reference's does,
  with the whole batch's capacity and slots over split rows.
* caches: ``kvheads`` (the KV heads over ``model`` where 16 divides
  them) or ``seqshard`` (the cache's rows over ``model``, long_500k's
  over ``("data", "model")``, Gemma2's ring among them: each rank runs
  the dense decode kernel on its block of rows and the ranks' outputs
  are combined from the kernel's lse);
* ``decode_2d`` (the big models' decode): the activations hold every
  slot and their d is split over ``data``; each product contracts the
  rank's block of d and sums its partial results, no weight is gathered
  (``build_serve_step``; the MoE layer's experts each on their ``model``
  rank).

The model code acts on the placement through ``distributed/
sharding.py``.  On a ``LocalMesh`` every step is what it was: the plan
acts only through ``remat``, ``microbatches`` and ``opt_dtype``.

The other families' train and prefill steps run unplaced (whole trees
on every rank) on a ``DeviceMesh``, and their ``Built`` carries no
placements; their serve steps are not placed yet and raise when called
there.

The steps run on the device of the tensors they are given; the model is
built on the card unless the caller passes ``device="cpu"`` (or
``"meta"``, for shapes and operation counts only).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import Placement, axis_rules
from repro_torch.launch.mesh import is_device_mesh
from repro_torch.launch.plans import (Plan, activation_rules, cache_specs_for,
                                      param_specs, spec_leaves)
from repro_torch.models import model as model_lib
from repro_torch.rl.losses import LossConfig, total_loss
from repro_torch.rl.trainer import value_and_grad
from repro_torch.train.optimizer import (AdamWConfig, OptState, adamw_update,
                                         tree_map)


@dataclasses.dataclass
class Built:
    """Everything dryrun/train needs for one combination."""
    fn: Any                     # the step function
    in_specs: Tuple             # meta tensors of the whole trees (positional)
    donate_argnums: Tuple[int, ...]   # arguments the step updates in place
    rules: Dict[str, Any]
    model: Any
    mesh: Any = None
    # spec trees of the inputs and outputs as a rank holds them (None:
    # the step is not placed, every rank holds the whole trees)
    in_shardings: Optional[Tuple] = None
    out_shardings: Optional[Tuple] = None


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


AXIS_SIZE = {"pod": 2, "data": 16, "model": 16}


def _fit_batch_axes(B: int, axes) -> Tuple[str, ...]:
    """Trim trailing mesh axes until their product (at the production
    mesh's sizes) divides the batch."""
    axes = tuple(axes)
    while axes:
        if B % math.prod(AXIS_SIZE[a] for a in axes) == 0:
            return axes
        axes = axes[:-1]
    return ()


def _batch_spec(B: int, axes) -> Tuple:
    """The batch dim's spec entry as a one-entry tuple, or () where no
    fitted axis divides it (the reference's ``P(...)``)."""
    fit = _fit_batch_axes(B, axes)
    if not fit:
        return ()
    return (fit if len(fit) > 1 else fit[0],)


def _batch_specs(batch_shape: Dict[str, torch.Tensor], axes
                 ) -> Dict[str, Tuple]:
    """A batch dict's spec tuples: the leading dim by ``_batch_spec``,
    every other dim replicated."""
    return {k: (tuple(_batch_spec(v.shape[0], axes)) + (None,) * v.ndim
                )[:v.ndim] for k, v in batch_shape.items()}


PLACED_FAMILIES = ("dense", "moe")


def _placed(cfg: ModelConfig, mesh) -> bool:
    """The steps of ``PLACED_FAMILIES`` on a ``DeviceMesh`` run placed."""
    return cfg.family in PLACED_FAMILIES and is_device_mesh(mesh)


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
    Parameters and moments are updated in place.

    Placed (the module docstring), the rank's rows go through in
    ``plan.microbatches`` slices, each the rank's part of one of the
    reference's microbatches (its slice i holds global rows of microbatch
    ``(block * n + i) // blocks``), whose masked means take that whole
    microbatch's token count; the gradients are then summed over the
    batch axes (``sharding.sync_grads``), the grad norm is the unsharded
    tree's and the loss and metrics are the whole batch's."""
    cfg = cfg.replace(remat=plan.remat)
    rules = activation_rules(plan, multi_pod, "train")
    baxes = _batch_axes(multi_pod, plan)
    model = model_lib.build_model(cfg, device=device,
                                  ep_mesh=_ep_mesh(cfg, mesh),
                                  data_axes=baxes)
    loss_cfg = LossConfig()
    opt_cfg = AdamWConfig(state_dtype=plan.opt_dtype)
    nmicro = plan.microbatches

    params_shape = _meta_params(cfg)
    pspecs = param_specs(params_shape, cfg, plan)
    batch_shape = model_lib.input_specs(cfg, shape.seq_len,
                                        shape.global_batch, "train")
    bspecs = _batch_specs(batch_shape, baxes)
    placed = _placed(cfg, mesh)
    placement = (Placement(_fit_batch_axes(shape.global_batch, baxes), pspecs,
                           vocab=cfg.vocab_size) if placed else None)
    pleaves = spec_leaves(pspecs) if placed else None

    def loss_fn(params, batch, den):
        logits, aux = model.forward(params, batch)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            logits = logits[:, model.prefill_extra:]
        return total_loss(logits, aux, batch, loss_cfg, den=den)

    def train_step(params, opt_state, batch):
        with axis_rules(mesh, rules, placement):
            B_l = batch["tokens"].shape[0]
            nb = math.prod(a.size for a in SH.batch_axes())
            if B_l % nmicro:
                raise ValueError(f"train step: {nmicro} microbatches do "
                                 f"not divide the rank's {B_l} rows")
            # each reference microbatch's token count (whole batch)
            counts = SH.gather_batch(batch["loss_mask"].sum(dim=1))
            dens = torch.clamp(counts.reshape(nmicro, -1).sum(dim=1),
                               min=1.0)
            blk = SH.block_index(SH.batch_axes())
            rows = B_l // nmicro
            grads, loss = None, 0.0
            for i in range(nmicro):
                mb = batch if nmicro == 1 else {
                    k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                (l, metrics), g = value_and_grad(
                    loss_fn, params, mb, dens[(blk * nmicro + i) // nb])
                # summed in place: one gradient tree beside the slice's
                # (the reference's adds, in the same dtype)
                grads = g if grads is None else [
                    a.add_(b) for a, b in zip(grads, g)]
                del g
                loss = loss + l
            if nmicro == 1:
                metrics = {k: SH.sum_batch(v.detach())
                           for k, v in metrics.items()}
            else:
                grads = [g.div_(nmicro) for g in grads]
                loss = loss / nmicro
                metrics = {}
            grads = SH.sync_grads(grads, pleaves)
            gnorm = SH.placed_global_norm(grads, pleaves) if placed else None
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 opt_cfg, gnorm=gnorm)
            metrics.update(om)
            metrics["loss"] = SH.sum_batch(loss)
            return params, opt_state, metrics

    def moments(p):
        return torch.empty(p.shape, dtype=plan.opt_dtype, device=p.device)
    opt_shape = OptState(
        step=torch.empty((), dtype=torch.int32, device=model_lib.META),
        m=tree_map(moments, params_shape), v=tree_map(moments, params_shape))
    ospecs = OptState(step=(), m=pspecs, v=pspecs)
    return Built(fn=train_step,
                 in_specs=(params_shape, opt_shape, batch_shape),
                 donate_argnums=(0, 1), rules=rules, model=model, mesh=mesh,
                 in_shardings=((pspecs, ospecs, bspecs) if placed else None),
                 out_shardings=((pspecs, ospecs, None) if placed else None))


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, plan: Plan,
                       mesh, multi_pod: bool, device=None) -> Built:
    """(params, batch, cache) -> (next token (B,) int32, cache).  The token
    is the argmax at column -1 of the logits, as in the reference: the
    padded width's last column, which is a row's prompt end only where
    the prompt fills the width (or the family pads on the left).  Placed,
    the token is the whole batch's on every rank (the argmax over the
    vocabulary's blocks) and the cache the rank's block."""
    cfg = cfg.replace(remat=False)
    rules = activation_rules(plan, multi_pod, "prefill")
    baxes = _batch_axes(multi_pod, plan)
    model = model_lib.build_model(cfg, device=device,
                                  ep_mesh=_ep_mesh(cfg, mesh),
                                  data_axes=baxes)
    max_len = _round_len(shape.seq_len + model.prefill_extra + 8)
    B = shape.global_batch
    params_shape = _meta_params(cfg)
    batch_shape = model_lib.input_specs(cfg, shape.seq_len, B, "prefill")
    cache_shape = model_lib.cache_specs(cfg, B, max_len)
    pspecs = param_specs(params_shape, cfg, plan)
    bspecs = _batch_specs(batch_shape, baxes)
    cspecs = cache_specs_for(cache_shape, cfg, plan, B, multi_pod)
    placed = _placed(cfg, mesh)
    placement = (Placement(_fit_batch_axes(B, baxes), pspecs, cspecs,
                           cfg.vocab_size) if placed else None)

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        if placed:
            _check_cache_rows(cspecs, placement.batch_axes, "prefill")
            if any(SH.entry_axes(s[2]) for s in cspecs.values()):
                raise NotImplementedError("prefill into a cache split over "
                                          "its sequence axis")
        with axis_rules(mesh, rules, placement):
            logits, cache = model.prefill(params, batch, cache)
            last = logits[:, -1]
            tok = SH.split_argmax(last).to(torch.int32)
            return SH.gather_batch(tok), cache

    return Built(fn=prefill_step,
                 in_specs=(params_shape, batch_shape, cache_shape),
                 donate_argnums=(2,), rules=rules, model=model, mesh=mesh,
                 in_shardings=((pspecs, bspecs, cspecs) if placed else None),
                 out_shardings=(((None,), cspecs) if placed else None))


def _check_cache_rows(cspecs, batch_axes, what: str) -> None:
    """The placed cache's slot dim (1) is split over the batch's axes."""
    for name, spec in cspecs.items():
        if SH.entry_axes(spec[1]) != tuple(batch_axes):
            raise NotImplementedError(
                f"{what}: cache {name!r} slots over {spec[1]}, the batch "
                f"over {batch_axes}")


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig, plan: Plan,
                     mesh, multi_pod: bool, device=None) -> Built:
    """Decode: ONE new token against a seq_len KV cache.
    (params, token, cache, kv_len) -> (argmax of the f32 logits (B,)
    int32, its f32 log-softmax (B,), cache).  Placed, the token, kv_len
    and outputs are the rank's rows and the cache its block (a
    ``seqshard`` cache's rows, a ring's among them, combined over their
    axes from the dense decode's lse; ``transformer.cache_attend``).

    Under ``decode_2d`` the activations hold every row (the ``batch``
    rule is None) and their d is split over ``data`` (the ``embed``
    rule): each product contracts the rank's block of d and sums the
    partial results, no weight is gathered.  The token and kv_len still
    come in, and the outputs leave, as the rank's rows over ``data`` (the
    reference's batch spec, reconciled by its compiler), so the step
    gathers them first and returns its rows; the cache's slots are split
    over ``data`` too, so each rank attends its own slots and the outputs
    are gathered over ``data``.  The MoE layers are the dense-dispatch
    layer, placed (``moe.moe_mlp_dense``).  On a ``DeviceMesh`` the
    serve steps of the families outside ``PLACED_FAMILIES`` are not
    placed yet and raise."""
    cfg = cfg.replace(remat=False)
    rules = activation_rules(plan, multi_pod, "decode")
    baxes = _batch_axes(multi_pod, plan)
    # decode uses the dense-dispatch MoE layer, as the reference's does
    model = model_lib.build_model(cfg, device=device)
    max_len = _round_len(shape.seq_len + model.prefill_extra + 8)
    B = shape.global_batch
    params_shape = _meta_params(cfg)
    step = model_lib.input_specs(cfg, shape.seq_len, B, "decode")
    cache_shape = model_lib.cache_specs(cfg, B, max_len)
    pspecs = param_specs(params_shape, cfg, plan)
    cspecs = cache_specs_for(cache_shape, cfg, plan, B, multi_pod)
    tspec = tuple(_batch_spec(B, baxes)) or (None,)
    placed = _placed(cfg, mesh)
    placement = None
    if placed:
        rows = _fit_batch_axes(B, baxes)
        placement = Placement(() if plan.decode_2d else rows, pspecs, cspecs,
                              cfg.vocab_size)

    @torch.no_grad()
    def serve_step(params, token, cache, kv_len):
        if is_device_mesh(mesh) and not placed:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family's serve step is not "
                "placed on a DeviceMesh yet")
        if placed:
            _check_cache_rows(cspecs, rows, "serve")
        with axis_rules(mesh, rules, placement):
            io = SH.step_axes(SH.entry_axes(tspec[0]))
            token, kv_len = SH.gather_over(token, io), SH.gather_over(kv_len,
                                                                      io)
            logits, cache = model.decode_step(params, token, cache, kv_len)
            lf = logits.float()
            nxt = SH.split_argmax(lf)
            ax = SH.vocab_split()
            if ax is None:
                lp = torch.log_softmax(lf, dim=-1).gather(
                    1, nxt[:, None])[:, 0]
            else:
                lp = SH.split_pick(lf, nxt, ax) - SH.split_logsumexp(lf, ax)
            return (SH.block_over(nxt.to(torch.int32), io),
                    SH.block_over(lp, io), cache)

    return Built(fn=serve_step,
                 in_specs=(params_shape, step["token"], cache_shape,
                           step["kv_len"]),
                 donate_argnums=(2,), rules=rules, model=model, mesh=mesh,
                 in_shardings=((pspecs, tspec, cspecs, tspec)
                               if placed else None),
                 out_shardings=((tspec, tspec, cspecs) if placed else None))


def build_step(cfg: ModelConfig, shape: ShapeConfig, plan: Plan, mesh,
               multi_pod: bool, device=None) -> Built:
    if shape.kind == "train":
        return build_train_step(cfg, shape, plan, mesh, multi_pod, device)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, plan, mesh, multi_pod, device)
    return build_serve_step(cfg, shape, plan, mesh, multi_pod, device)
