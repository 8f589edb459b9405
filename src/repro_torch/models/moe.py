"""Mixture-of-Experts FFN (counterpart of ``repro/models/moe.py``): top-k
routing with a per-expert capacity, assignments past it dropped.

``moe_mlp_dense`` is the reference's capacity-based scatter/gather path,
kept exactly: one capacity ``C = max(4, ceil(cf * k * T / E))`` for all
``T = B * S`` tokens of the call, slots assigned in token-major order by a
cumsum, so the same (token, expert) pairs are dropped.  A token's output
therefore depends on the batch it rides in: the engine's decode calls it on
every slot (idle ones included) and its prefill on the whole bucketed wave
(pad columns included), as the reference's do.  ``moe_mlp_ref`` is the
reference's no-drop oracle, for the tests.  Placed on a ``DeviceMesh``
(``distributed/sharding.py``: the serve steps and the trainer's update)
it is still one call on the whole batch, as the reference's compiler
partitions it: a rank holding some of the rows takes the whole batch's
capacity, slots and aux losses.

``moe_mlp_ep`` is the reference's expert-parallel layer over a
``DeviceMesh`` (``launch/mesh.py``), line for line: each (data, model)
rank routes its own block of the tokens (B over the data axes, S over
``model``) under its own capacity ``C = _capacity(cfg, T_l)``, the
expert axis padded with never-routed zero experts to ``E_pad``, a
multiple of the model axis; the (n_model, E_local, C, d) buffers cross
the model axis with ``all_to_all_single`` to the rank owning the
experts, which runs only its ``E_local`` of them.  It runs under a
placement (``distributed/sharding.py``), as the placed train and
prefill steps install one: it takes the placed residual and tree.  On a
mesh of more than one rank this is other arithmetic than
``moe_mlp_dense``'s (other capacities, other drops).
Its router losses are the mean over every rank of the mesh, which is
what the reference's backward differentiates; the reference's forward
returns data shard 0's value instead (``ROADMAP.md`` section 3).

The three expert products are batched matrix products (``torch.bmm``);
the router is f32 whatever the parameter dtype, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as COL
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as MESH
from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def init_moe_mlp(gen: torch.Generator, cfg: ModelConfig, dtype,
                 device) -> Params:
    """``router`` (d, E) f32, ``w_in``/``w_gate`` (E, d, f), ``w_out``
    (E, f, d) in ``dtype``, plus ``shared`` (a gated MLP) when
    ``d_ff_shared``; the reference's scales."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    sd_in = 1.0 / math.sqrt(d)
    sd_out = 1.0 / math.sqrt(f * 2 * cfg.num_layers)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    p = {
        "router": (normal(d, E) * sd_in).float(),
        "w_in": (normal(E, d, f) * sd_in).to(dtype),
        "w_gate": (normal(E, d, f) * sd_in).to(dtype),
        "w_out": (normal(E, f, d) * sd_out).to(dtype),
    }
    if m.d_ff_shared:
        p["shared"] = L.init_mlp(gen, d, m.d_ff_shared, True, cfg.num_layers,
                                 dtype, device)
    return p


def top_k_lowest_first(x: torch.Tensor, k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last axis and their indices, equal
    values in ascending index order, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties): a stable descending
    sort, cut to ``k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Params, cfg: ModelConfig, x2d: torch.Tensor,
           with_aux: bool = True):
    """x2d (T, d) -> (gates (T, k) f32, idx (T, k) int64, aux).  The
    Switch-style load-balance and z losses in ``aux``, or None when
    ``with_aux`` is off (callers that discard it).

    Under a placement (``distributed/sharding.py``) the logits are summed
    over the embed axis (``decode_2d``: x2d and the router hold the rank's
    block of d) and the losses are the whole batch's: the density, the
    mean probabilities and the z term totalled over the batch's axes
    (``sharding.batch_mean``), the reference's ``_route`` on every token
    of the call."""
    m = cfg.moe
    logits = SH.contract(x2d.float() @ p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k_lowest_first(probs, m.experts_per_token)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if not with_aux:
        return gates, idx, None
    density = SH.batch_mean(F.one_hot(idx[:, 0], m.num_experts).float())
    z = torch.square(torch.logsumexp(logits, -1))
    aux = {
        "load_balance": m.num_experts * torch.sum(
            density * SH.batch_mean(probs)),
        "router_z": SH.batch_mean(z),
    }
    return gates, idx, aux


def _capacity(cfg: ModelConfig, T: int) -> int:
    m = cfg.moe
    c = int(math.ceil(m.capacity_factor * m.experts_per_token * T
                      / m.num_experts))
    return max(4, c)


def _dispatch_indices(idx: torch.Tensor, E: int, C: int,
                      offset: Optional[torch.Tensor] = None):
    """idx (T, k) expert ids -> (pos (T, k) slot in the expert, keep (T, k)
    bool): slots assigned in routing order (token-major, then j), the
    pairs at or past capacity C dropped.  ``offset`` (E,): each expert's
    pairs routed before these tokens (a rank's rows of a whole batch,
    ``sharding.batch_offset``), added to their slots."""
    T, k = idx.shape
    flat = idx.reshape(-1).long()
    onehot = F.one_hot(flat, E).to(torch.int32)            # (T*k, E)
    pos_flat = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
    pos = torch.gather(pos_flat, 1, flat[:, None])[:, 0].long()
    if offset is not None:
        pos = pos + offset.long()[flat]
    keep = pos < C
    return pos.reshape(T, k), keep.reshape(T, k)


def _activate(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(h)
    if act == "relu2":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")        # jax.nn.gelu's default


def _expert_ffn(p: Params, xe: torch.Tensor, act: str) -> torch.Tensor:
    """xe (E, C, d) -> (E, C, d).  Under ``decode_2d`` xe and the weights
    hold the rank's block of d: the two input products are summed over
    the embed axis (``sharding.contract``) and the output is the rank's
    block of d."""
    a = _activate(SH.contract(torch.bmm(xe, p["w_in"])), act)
    return torch.bmm(a * SH.contract(torch.bmm(xe, p["w_gate"])),
                     p["w_out"])


MLP_PATH = ("layers", "mlp")


def _dense_experts(p: Params) -> Tuple[Params, int, bool]:
    """(router and expert weights as the rank computes with them, the
    first expert it computes, whether the experts are split over the model
    axis).  Under a placement: each FSDP dim gathered, under the embed
    axis the rank's block of d; experts stored split over the model axis
    are the rank's block (its output is then a partial sum over the axis,
    and the router's and the input's gradients partial), else every
    expert, computed alike on every rank of the axis."""
    ax = SH.model_axis()
    spec = SH.param_spec(MLP_PATH + ("w_in",), 3)
    split = ax is not None and ax.name in SH.entry_axes(spec[0])
    w = {"router": SH.weight(p["router"], MLP_PATH + ("router",), embed=0,
                             sum_model=split)}
    for k, embed in (("w_in", 1), ("w_gate", 1), ("w_out", 2)):
        w[k] = SH.weight(p[k], MLP_PATH + (k,), embed=embed,
                         sum_model=split)
    return w, (ax.rank * w["w_in"].shape[0] if split else 0), split


def moe_mlp_dense(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  with_aux: bool = True
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x (B, S, d) -> (y (B, S, d), aux): every kept pair scattered into
    its expert's (E, C, d) buffer, the experts' FFN, then gathered back
    and summed over j in f32 (dropped pairs add zero), cast to x's dtype.
    The scatter accumulates: a dropped pair adds zeros at (e, C - 1), the
    cell a kept pair may hold.  ``with_aux=False`` skips the router
    losses (aux None), for callers that discard them.

    Under a placement (``distributed/sharding.py``; the weights' specs
    are the tree's ``layers.mlp``'s) the layer is the reference's, which its
    compiler partitions as one call on the whole batch: where the rows are
    split over the batch's axes, C is the whole batch's and each expert's
    slots start after the pairs of the blocks before the rank's
    (``sharding.batch_offset``: E counts gathered, no token moves), so
    the drops are the reference's, and the aux is the whole batch's
    (``_route``).  Under ``decode_2d`` x holds every row and the rank's
    block of d (no weight gathered, ``_expert_ffn``); experts split over
    the model axis are computed by their rank and the outputs summed over
    the axis (``_dense_experts``)."""
    m = cfg.moe
    E, K = m.num_experts, m.experts_per_token
    B, S, d = x.shape
    T = B * S
    if SH.placed() and (SH.seq_parallel() or "shared" in p):
        raise NotImplementedError("moe_mlp_dense: placed over a "
                                  "sequence-parallel residual or with a "
                                  "shared expert")
    w, e0, split = _dense_experts(p)
    x2d = x.reshape(T, d)
    if split:
        x2d = SH.shared(x2d)
    gates, idx, aux = _route(w, cfg, x2d, with_aux)
    nb = SH.batch_count()
    C = _capacity(cfg, T * nb)
    if nb > 1:
        counts = F.one_hot(idx.reshape(-1), E).sum(0)
        pos, keep = _dispatch_indices(idx, E, C, SH.batch_offset(counts))
    else:
        pos, keep = _dispatch_indices(idx, E, C)
    E_l = w["w_in"].shape[0]
    if split:
        keep = keep & (idx >= e0) & (idx < e0 + E_l)
        idx = (idx - e0).clamp(0, E_l - 1)
    safe = torch.where(keep, pos, C - 1)
    buf = torch.zeros((E_l, C, d), dtype=x.dtype, device=x.device)
    for j in range(K):
        buf.index_put_((idx[:, j], safe[:, j]),
                       torch.where(keep[:, j, None], x2d, 0).to(x.dtype),
                       accumulate=True)
    out_e = _expert_ffn(w, buf, cfg.mlp_act)
    y2d = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(K):
        gathered = out_e[idx[:, j], safe[:, j]]
        y2d = y2d + torch.where(keep[:, j, None],
                                gathered.float() * gates[:, j, None], 0.0)
    if split:
        y2d = COL.all_reduce(y2d, SH.model_axis().group)
    y = y2d.reshape(B, S, d).to(x.dtype)
    if "shared" in p:
        y = y + L.mlp(p["shared"], x, "silu", True)
    return y, aux


EXPERT_KEYS = ("w_in", "w_gate", "w_out")


def expert_padding(E: int, n_model: int) -> Tuple[int, int]:
    """(E_pad, E_local): the expert axis padded up to a multiple of the
    model axis (Granite's 40 experts on a 16-way axis: 48, 3 a rank)."""
    E_pad = -(-E // n_model) * n_model
    return E_pad, E_pad // n_model


def _own_experts(w: torch.Tensor, E_local: int, c: int) -> torch.Tensor:
    """Experts ``[c * E_local, (c + 1) * E_local)`` of ``w`` (E, ...),
    padded with zero experts past E."""
    own = w[c * E_local:(c + 1) * E_local]
    pad = w.new_zeros((E_local - own.shape[0],) + tuple(w.shape[1:]))
    return torch.cat([own, pad])


def moe_mlp_ep(p: Params, cfg: ModelConfig, x: torch.Tensor, mesh,
               data_axes=("data",), model_axis: str = "model",
               with_aux: bool = True
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Expert-parallel MoE over ``mesh`` (a ``DeviceMesh``), the
    reference's ``moe_mlp_ep``: x (B, S, d) -> (y, aux).

    The rank works on the reference's ``shard_map`` block of x (B over
    ``data_axes``, S over ``model_axis``): it routes its block's tokens
    (padded experts' logits -1e30, ``density`` over the real E), fills
    (E_pad, C, d) with ``C = _capacity(cfg, B_l * S_l)``, sends it as
    (n_model, E_local, C, d) with ``all_to_all_single`` over the model
    axis, runs its own ``E_local`` experts on every source's tokens,
    sends the results back and combines them in f32.  The aux is the mean
    of every block's losses (each as ``_route``'s), what the reference's
    backward differentiates.

    It runs under a placement (``distributed/sharding.py``; the weights'
    specs are the tree's ``layers.mlp``'s).  x comes as the placed
    residual: its rows already split over the batch's axes, its S over
    the model axis under sequence parallelism; the rank cuts only the
    axes it comes whole over and y leaves in x's placement.  The weights are the placed tree's:
    each FSDP dim gathered (the gather reduce-scatters the gradient), the
    experts the stored block where they are split over the model axis,
    else the rank's ``E_local`` cut from the whole, whose gradient is then
    summed over the axis so the replicas stay equal.  A gradient is summed
    once: over the axes the layer cut and the model axis here, over the
    batch's axes at the step's end (``sharding.sync_grads``).  The aux
    blocks gathered over the batch's axes take the gradient summed there
    (each rank's loss carries ``1 / batch_count`` of it, ``total_loss``).

    Raises without a process group, on a mesh that is not a
    ``DeviceMesh``, without a placement, on a shared expert (the
    reference's MoE configs have none) and where the mesh does not divide
    B or S, as ``shard_map`` does."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("moe_mlp_ep: no process group is initialised")
    if not MESH.is_device_mesh(mesh):
        raise TypeError(f"moe_mlp_ep: needs a DeviceMesh, got {mesh!r}")
    if not SH.placed():
        raise RuntimeError("moe_mlp_ep: no placement is installed "
                           "(sharding.axis_rules with a Placement)")
    data_axes = tuple(data_axes)
    if model_axis in data_axes:
        raise ValueError(f"moe_mlp_ep: the batch axes {data_axes} and the "
                         f"sequence axis {model_axis!r} overlap")
    m = cfg.moe
    E, K = m.num_experts, m.experts_per_token
    n_model = MESH.axis_size(mesh, model_axis)
    E_pad, E_local = expert_padding(E, n_model)
    came = {a.name for a in SH.batch_axes()}
    if came - set(data_axes) or "shared" in p:
        raise NotImplementedError(
            f"moe_mlp_ep: placed with the batch over {sorted(came)} "
            f"(expert blocks over {data_axes}) or a shared expert")
    seq_came = SH.seq_parallel()
    B, S, d = x.shape
    data_groups = {a: MESH.axis_group(mesh, a) for a in data_axes}
    model_group = MESH.axis_group(mesh, model_axis)
    cut_data = [data_groups[a] for a in data_axes if a not in came]
    n_data = math.prod(MESH.axis_size(mesh, a) for a in data_axes
                       if a not in came)
    if B % n_data or (not seq_came and S % n_model):
        raise ValueError(f"moe_mlp_ep: x {tuple(x.shape)} does not divide "
                         f"over the mesh ({n_data} batch, {n_model} "
                         "sequence blocks)")
    cut = [(g, 0) for g in cut_data] + ([] if seq_came
                                        else [(model_group, 1)])
    router = COL.sum_grad(p["router"], cut_data + [model_group])
    c = mesh.get_local_rank(model_axis) if n_model > 1 else 0
    w = {}
    for k in EXPERT_KEYS:
        wk = SH.weight(p[k], MLP_PATH + (k,))
        if wk.shape[0] != E_local:
            wk = _own_experts(wk, E_local, c)
        w[k] = COL.sum_grad(wk, cut_data) if cut_data else wk

    xb = COL.to_block(x, cut)
    B_l, S_l = xb.shape[:2]
    T_l = B_l * S_l
    x2d = xb.reshape(T_l, d)
    logits = x2d.float() @ router.float()
    if E_pad > E:
        logits = F.pad(logits, (0, E_pad - E), value=-1e30)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k_lowest_first(probs, K)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    aux = None
    if with_aux:
        density = F.one_hot(idx[:, 0], E_pad)[:, :E].float().mean(0)
        every = torch.stack([
            E * torch.sum(density * probs[:, :E].mean(0)),
            torch.mean(torch.square(torch.logsumexp(logits, -1)))])[None]
        every = COL.from_blocks(every, [(g, 0) for g in cut_data]
                                + [(model_group, 0)])
        for a in reversed(SH.batch_axes()):
            every = COL.all_gather(every, a.group, 0)
        every = every.mean(0)
        aux = {"load_balance": every[0], "router_z": every[1]}
    C = _capacity(cfg, T_l)
    pos, keep = _dispatch_indices(idx, E_pad, C)
    safe = torch.where(keep, pos, C - 1)
    buf = torch.zeros((E_pad, C, d), dtype=xb.dtype, device=xb.device)
    for j in range(K):
        buf.index_put_((idx[:, j], safe[:, j]),
                       torch.where(keep[:, j, None], x2d, 0).to(xb.dtype),
                       accumulate=True)
    recv = COL.all_to_all(buf.reshape(n_model, E_local, C, d), model_group)
    xe = recv.transpose(0, 1).reshape(E_local, n_model * C, d)
    out_e = _expert_ffn(w, xe, cfg.mlp_act)
    back = COL.all_to_all(
        out_e.reshape(E_local, n_model, C, d).transpose(0, 1), model_group)
    back = back.reshape(E_pad, C, d)
    y2d = torch.zeros((T_l, d), dtype=torch.float32, device=x.device)
    for j in range(K):
        gathered = back[idx[:, j], safe[:, j]]
        y2d = y2d + torch.where(keep[:, j, None],
                                gathered.float() * gates[:, j, None], 0.0)
    return COL.from_blocks(y2d.reshape(B_l, S_l, d).to(x.dtype), cut), aux


def moe_mlp_ref(p: Params, cfg: ModelConfig, x: torch.Tensor
                ) -> torch.Tensor:
    """Oracle: a loop over the experts, no capacity drop.  For tests."""
    m = cfg.moe
    B, S, d = x.shape
    x2d = x.reshape(-1, d)
    gates, idx, _ = _route(p, cfg, x2d, with_aux=False)
    y = torch.zeros(x2d.shape, dtype=torch.float32, device=x.device)
    for e in range(m.num_experts):
        a = _activate(x2d @ p["w_in"][e], cfg.mlp_act)
        oe = ((a * (x2d @ p["w_gate"][e])) @ p["w_out"][e]).float()
        w = torch.where(idx == e, gates, 0.0).sum(1)
        y = y + oe * w[:, None]
    out = y.reshape(B, S, d).to(x.dtype)
    if "shared" in p:
        out = out + L.mlp(p["shared"], x, "silu", True)
    return out
