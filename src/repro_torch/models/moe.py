"""Mixture-of-Experts FFN (counterpart of ``repro/models/moe.py``): top-k
routing with a per-expert capacity, assignments past it dropped.

``moe_mlp_dense`` is the reference's capacity-based scatter/gather path,
kept exactly: one capacity ``C = max(4, ceil(cf * k * T / E))`` for all
``T = B * S`` tokens of the call, slots assigned in token-major order by a
cumsum, so the same (token, expert) pairs are dropped.  A token's output
therefore depends on the batch it rides in: the engine's decode calls it on
every slot (idle ones included) and its prefill on the whole bucketed wave
(pad columns included), as the reference's do.  ``moe_mlp_ref`` is the
reference's no-drop oracle, for the tests.

``moe_mlp_ep`` is the reference's expert-parallel layer over a
``DeviceMesh`` (``launch/mesh.py``), line for line: each (data, model)
rank routes its own block of the tokens (B over the data axes, S over
``model``) under its own capacity ``C = _capacity(cfg, T_l)``, the
expert axis padded with never-routed zero experts to ``E_pad``, a
multiple of the model axis; the (n_model, E_local, C, d) buffers cross
the model axis with ``all_to_all_single`` to the rank owning the
experts, which holds only its ``E_local`` of them (``shard_experts``,
once per parameter tree).  On a mesh of more than one rank this is other
arithmetic than ``moe_mlp_dense``'s (other capacities, other drops).
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
    ``with_aux`` is off (callers that discard it)."""
    m = cfg.moe
    logits = x2d.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = top_k_lowest_first(probs, m.experts_per_token)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if not with_aux:
        return gates, idx, None
    density = F.one_hot(idx[:, 0], m.num_experts).float().mean(0)
    aux = {
        "load_balance": m.num_experts * torch.sum(density * probs.mean(0)),
        "router_z": torch.mean(torch.square(torch.logsumexp(logits, -1))),
    }
    return gates, idx, aux


def _capacity(cfg: ModelConfig, T: int) -> int:
    m = cfg.moe
    c = int(math.ceil(m.capacity_factor * m.experts_per_token * T
                      / m.num_experts))
    return max(4, c)


def _dispatch_indices(idx: torch.Tensor, E: int, C: int):
    """idx (T, k) expert ids -> (pos (T, k) slot in the expert, keep (T, k)
    bool): slots assigned in routing order (token-major, then j), the
    pairs at or past capacity C dropped."""
    T, k = idx.shape
    flat = idx.reshape(-1).long()
    onehot = F.one_hot(flat, E).to(torch.int32)            # (T*k, E)
    pos_flat = torch.cumsum(onehot, 0, dtype=torch.int32) - onehot
    pos = torch.gather(pos_flat, 1, flat[:, None])[:, 0].long()
    keep = pos < C
    return pos.reshape(T, k), keep.reshape(T, k)


def _activate(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(h)
    if act == "relu2":
        return torch.square(F.relu(h))
    return F.gelu(h, approximate="tanh")        # jax.nn.gelu's default


def _expert_ffn(p: Params, xe: torch.Tensor, act: str) -> torch.Tensor:
    """xe (E, C, d) -> (E, C, d)."""
    a = _activate(torch.bmm(xe, p["w_in"]), act)
    return torch.bmm(a * torch.bmm(xe, p["w_gate"]), p["w_out"])


def moe_mlp_dense(p: Params, cfg: ModelConfig, x: torch.Tensor,
                  with_aux: bool = True
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x (B, S, d) -> (y (B, S, d), aux): every kept pair scattered into
    its expert's (E, C, d) buffer, the experts' FFN, then gathered back
    and summed over j in f32 (dropped pairs add zero), cast to x's dtype.
    The scatter accumulates: a dropped pair adds zeros at (e, C - 1), the
    cell a kept pair may hold.  ``with_aux=False`` skips the router
    losses (aux None), for callers that discard them."""
    m = cfg.moe
    E, K = m.num_experts, m.experts_per_token
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    gates, idx, aux = _route(p, cfg, x2d, with_aux)
    C = _capacity(cfg, T)
    pos, keep = _dispatch_indices(idx, E, C)
    safe = torch.where(keep, pos, C - 1)
    buf = torch.zeros((E, C, d), dtype=x.dtype, device=x.device)
    for j in range(K):
        buf.index_put_((idx[:, j], safe[:, j]),
                       torch.where(keep[:, j, None], x2d, 0).to(x.dtype),
                       accumulate=True)
    out_e = _expert_ffn(p, buf, cfg.mlp_act)
    y2d = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for j in range(K):
        gathered = out_e[idx[:, j], safe[:, j]]
        y2d = y2d + torch.where(keep[:, j, None],
                                gathered.float() * gates[:, j, None], 0.0)
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


def shard_experts(params: Params, cfg: ModelConfig, mesh,
                  model_axis: str = "model") -> Params:
    """The parameter tree with every expert weight (``layers.mlp.w_in``,
    ``w_gate``, ``w_out``: (L, E, ...)) padded with zero experts to
    ``E_pad`` and cut to this rank's ``E_local`` along the model axis of
    ``mesh``, as the reference pads and then shards them.  The rest of
    the tree is shared, not copied.  For ``moe_mlp_ep``; once per tree."""
    n = MESH.axis_size(mesh, model_axis)
    _, E_local = expert_padding(cfg.moe.num_experts, n)
    c = mesh.get_local_rank(model_axis) if n > 1 else 0

    def cut(w):
        own = w[:, c * E_local:(c + 1) * E_local]
        pad = torch.zeros((w.shape[0], E_local - own.shape[1]) + w.shape[2:],
                          dtype=w.dtype, device=w.device)
        return torch.cat([own, pad], 1)
    mlp = dict(params["layers"]["mlp"])
    mlp.update({k: cut(mlp[k]) for k in EXPERT_KEYS})
    return dict(params, layers=dict(params["layers"], mlp=mlp))


def expert_leaf_mask(params: Params):
    """Per leaf of ``params`` in ``tree_leaves`` order (sorted keys): is
    it an expert weight (``layers.mlp.w_in``, ``w_gate``, ``w_out``)."""
    def mark(tree, path):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in mark(tree[k],
                                                          path + (k,))]
        return [path[:2] == ("layers", "mlp") and len(path) == 3
                and path[2] in EXPERT_KEYS]
    return mark(params, ())


def ep_global_norm(params: Params, grads, mesh,
                   model_axis: str = "model") -> torch.Tensor:
    """The global gradient norm of the unsharded tree, on every rank:
    each leaf's sum of squares, the expert leaves' summed over the model
    axis (each rank holds ``E_local`` of the experts; the zero experts'
    gradients are zero), in ``tree_leaves`` order as ``global_norm``."""
    sq = [torch.sum(torch.square(g.float())) for g in grads]
    mask = expert_leaf_mask(params)
    idx = [i for i, e in enumerate(mask) if e]
    if idx:
        summed = COL.sum_over(torch.stack([sq[i] for i in idx]),
                              [MESH.axis_group(mesh, model_axis)])
        for j, i in enumerate(idx):
            sq[i] = summed[j]
    return torch.sqrt(sum(sq))


def moe_mlp_ep(p: Params, cfg: ModelConfig, x: torch.Tensor, mesh,
               data_axes=("data",), model_axis: str = "model",
               with_aux: bool = True
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Expert-parallel MoE over ``mesh`` (a ``DeviceMesh``), the
    reference's ``moe_mlp_ep``.  x (B, S, d), the same on every rank ->
    (y (B, S, d), the same on every rank, aux).

    ``p``'s expert weights are this rank's (E_local, ...) slices
    (``shard_experts``); the router is the full (d, E) f32.  The rank
    takes its block of x (B over ``data_axes``, S over ``model_axis``),
    routes it (padded experts' logits -1e30, ``density`` over the real E),
    fills (E_pad, C, d) with ``C = _capacity(cfg, B_l * S_l)``, sends it
    as (n_model, E_local, C, d) with ``all_to_all_single`` over the model
    axis, runs its own experts on every source's tokens, sends the
    results back, combines in f32 and gathers the blocks into y.  The
    ``shared`` MLP is added outside the exchange, on the full x.

    Gradients are ``jax.grad`` of the reference's on every rank
    (``distributed/collectives.py``): x's gathered back to full, the
    router's summed over the mesh, the experts' over the data axes.  The
    aux is the mean over every rank of the mesh (each block's losses, as
    ``_route``'s).  Raises without a process group, on a mesh that is not
    a ``DeviceMesh``, on expert weights not cut to ``E_local``, and where
    the mesh does not divide B or S, as ``shard_map`` does."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("moe_mlp_ep: no process group is initialised")
    if not MESH.is_device_mesh(mesh):
        raise TypeError(f"moe_mlp_ep: needs a DeviceMesh, got {mesh!r}")
    data_axes = tuple(data_axes)
    if model_axis in data_axes:
        raise ValueError(f"moe_mlp_ep: the batch axes {data_axes} and the "
                         f"sequence axis {model_axis!r} overlap")
    m = cfg.moe
    E, K = m.num_experts, m.experts_per_token
    n_model = MESH.axis_size(mesh, model_axis)
    E_pad, E_local = expert_padding(E, n_model)
    for k in EXPERT_KEYS:
        if p[k].shape[0] != E_local:
            raise ValueError(
                f"moe_mlp_ep: {k} holds {p[k].shape[0]} experts, this "
                f"rank owns {E_local} of {E_pad}; cut the tree with "
                "shard_experts")
    B, S, d = x.shape
    n_data = math.prod(MESH.axis_size(mesh, a) for a in data_axes)
    if B % n_data or S % n_model:
        raise ValueError(f"moe_mlp_ep: x {tuple(x.shape)} does not divide "
                         f"over the mesh ({n_data} batch, {n_model} "
                         "sequence blocks)")
    data_groups = [MESH.axis_group(mesh, a) for a in data_axes]
    model_group = MESH.axis_group(mesh, model_axis)
    split = [(g, 0) for g in data_groups] + [(model_group, 1)]
    router = COL.sum_grad(p["router"], data_groups + [model_group])
    w = {k: COL.sum_grad(p[k], data_groups) for k in EXPERT_KEYS}

    xb = COL.to_block(x, split)
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
        block = torch.stack([
            E * torch.sum(density * probs[:, :E].mean(0)),
            torch.mean(torch.square(torch.logsumexp(logits, -1)))])
        every = COL.from_blocks(
            block[None], [(g, 0) for g in data_groups + [model_group]]
        ).mean(0)
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
    y = COL.from_blocks(y2d.reshape(B_l, S_l, d).to(x.dtype), split)
    if "shared" in p:
        y = y + L.mlp(p["shared"], x, "silu", True)
    return y, aux


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
