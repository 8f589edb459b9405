"""Unified model interface (counterpart of ``repro/models/model.py``):
``build_model(cfg)`` returns a :class:`Model` bundle of functions.

Batch dict conventions are the reference's:
* scoring : {"tokens": (B, S)}
* prefill : {"tokens": (B, S), "prompt_lens": (B,)} (+ "seg_ids",
  "positions" for ``prefill_packed``)
* decode  : token (B,), dense cache (``decode_step``) or page pool and
  block tables (B, nb) (``decode_step_paged``), kv_len (B,)

The dense family is ported with both layer patterns: the gemma2
local/global pattern has a four-key cache, so it takes the dense layout
only (``decode_step`` dispatches to its decode; ``prefill_packed`` and
``decode_step_paged`` refuse it, as the reference's asserts do).  The MoE
family is the same backbone and the same functions, its blocks' MLP the
expert layer (``models/moe.py``, the reference's ``moe_mlp_dense``;
``forward`` returns the router losses summed over the layers).  The
reference's ``ep_mesh`` (expert parallelism over a device mesh) has no
counterpart yet.  The model lives on one device, the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable          # (generator) -> params
    forward: Callable              # (params, batch) -> (logits, aux)
    init_cache: Callable           # (batch_size, max_len) -> cache
    prefill: Callable              # (params, batch, cache) -> (logits, cache)
    decode_step_paged: Callable    # (params, token, pool, bt, kv_len, **kw)
    prefill_packed: Callable       # (params, batch, cache) -> (logits, cache)
    decode_step: Callable          # (params, token, cache, kv_len, **kw)


def build_model(cfg: ModelConfig, device=None) -> Model:
    TF.check_supported(cfg)
    dev = resolve_device(device)

    def init_params(generator: torch.Generator):
        return TF.init_params(cfg, generator, dev)

    def forward(params, batch):
        return TF.forward(params, cfg, batch["tokens"])

    def init_cache(batch_size, max_len):
        return TF.init_cache(cfg, batch_size, max_len, dev)

    def prefill(params, batch, cache, return_logits=True):
        return TF.prefill(params, cfg, batch["tokens"], cache,
                          batch["prompt_lens"], return_logits=return_logits)

    def prefill_packed(params, batch, cache, return_logits=True):
        return TF.prefill(params, cfg, batch["tokens"], cache,
                          batch["prompt_lens"], seg_ids=batch["seg_ids"],
                          positions=batch["positions"],
                          return_logits=return_logits)

    def decode_step_paged(params, token, pool, block_tables, kv_len, **kw):
        return TF.decode_step_paged(params, cfg, token, pool, block_tables,
                                    kv_len, **kw)

    def decode_step(params, token, cache, kv_len, **kw):
        return TF.decode(params, cfg, token, cache, kv_len, **kw)

    return Model(cfg, dev, init_params, forward, init_cache, prefill,
                 decode_step_paged, prefill_packed, decode_step)


def supports_paging(model: Model) -> bool:
    """Paged layout needs right padding and a plain {k, v} cache: every
    family the port serves so far (dense and MoE) pads right; the
    local/global pattern's four-key cache cannot be paged."""
    return set(model.init_cache(1, 1)) == {"k", "v"}
