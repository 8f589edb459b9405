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

The reference's expert-parallel ``moe_mlp_ep`` (``shard_map`` and
``all_to_all`` over a device mesh) waits for a distributed port.

The three expert products are batched matrix products (``torch.bmm``);
the router is f32 whatever the parameter dtype, as in the reference.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
