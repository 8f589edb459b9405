"""Unified model interface (counterpart of ``repro/models/model.py``):
``build_model(cfg)`` returns a :class:`Model` bundle of functions.

Batch dict conventions are the reference's:
* scoring : {"tokens": (B, S)} (+ "patch_embeds" (B, P, d) for vlm,
  "frames" (B, T_enc, d) for audio: the stub frontends' inputs)
* prefill : {"tokens": (B, S), "prompt_lens": (B,)} (+ "seg_ids",
  "positions" for ``prefill_packed``; + the stub inputs as above)
* decode  : token (B,), dense cache (``decode_step``) or page pool and
  block tables (B, nb) (``decode_step_paged``), kv_len (B,)

The dense family is ported with both layer patterns: the gemma2
local/global pattern has a four-key cache, so it takes the dense layout
only (``decode_step`` dispatches to its decode; ``prefill_packed`` and
``decode_step_paged`` refuse it, as the reference's asserts do).  The MoE
family is the same backbone and the same functions, its blocks' MLP the
expert layer (``models/moe.py``, the reference's ``moe_mlp_dense``;
``forward`` returns the router losses summed over the layers).  The
vision-language family (``vlm``) is the dense backbone behind the
reference's stub frontend: a batch's ``patch_embeds`` (B, P, d) go
before its tokens' embeddings in ``forward`` and ``prefill``, so a
prefill fills P + S cache rows (``prefill_extra`` = P), and it has no
packed prefill (``prefill_packed`` None), as in the reference.  The
audio family is the whisper encoder-decoder (``models/whisper.py``):
``frames`` feed the encoder, its four-key cache takes the dense layout
only, and it has neither a packed prefill nor a paged decode.  The
hybrid family (Zamba2: Mamba2 layers and a shared attention block,
``models/hybrid.py``) and the ssm family (xLSTM, ``models/xlstm.py``)
carry recurrent state, so they pad prompts on the left
(``padding_side == "left"``) and take the dense layout only; the
hybrid's ``decode_step`` takes ``kv_start``, a slot's first live cache
row (its attention reads rows ``[kv_start, kv_len]``).  The model lives
on one device, the card unless the caller passes ``device="cpu"``.

``ep_mesh`` (a ``DeviceMesh``, the MoE family only) is the reference's
expert parallelism: every block's MLP is ``moe_mlp_ep`` over it (with
``data_axes`` the batch's mesh axes), and there is no paged decode (the
reference has none for it), and the steps run it under a placement.
``init_params`` returns the whole tree; a placed step takes each rank's
blocks of it (``launch/plans.py`` ``place``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid as HY
from repro_torch.models import transformer as TF
from repro_torch.models import whisper as WH
from repro_torch.models import xlstm as XL


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    init_params: Callable          # (generator) -> params
    forward: Callable              # (params, batch) -> (logits, aux)
    init_cache: Callable           # (batch_size, max_len) -> cache
    prefill: Callable              # (params, batch, cache) -> (logits, cache)
    decode_step_paged: Optional[Callable]  # (params, token, pool, bt, kv_len)
    prefill_packed: Optional[Callable]     # (params, batch, cache)
    decode_step: Callable          # (params, token, cache, kv_len, **kw)
    padding_side: str = "right"    # "right" | "left" (hybrid, ssm)
    prefill_extra: int = 0         # cache rows prepended by the stub frontend


FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


def build_model(cfg: ModelConfig, device=None, ep_mesh=None,
                data_axes=("data",)) -> Model:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r}")
    if cfg.family != "moe":
        ep_mesh = None
    if cfg.family not in ("ssm", "audio"):
        TF.check_supported(cfg)
    dev = resolve_device(device)
    if cfg.family == "audio":
        return _build_audio(cfg, dev)
    if cfg.family in ("hybrid", "ssm"):
        return _build_recurrent(cfg, dev)
    vlm = cfg.family == "vlm"

    def embeds(params, batch):
        """The stub patch rows, then the tokens' embeddings (vlm only)."""
        if not (vlm and "patch_embeds" in batch):
            return None
        tok = TF.embed_tokens(params, cfg, batch["tokens"])
        return torch.cat([batch["patch_embeds"].to(tok.dtype), tok], dim=1)

    mlp, mlp_no_aux = (TF.mlp_fn(cfg, aux, ep_mesh, data_axes)
                       for aux in (True, False))

    def init_params(generator: torch.Generator):
        return TF.init_params(cfg, generator, dev)

    def forward(params, batch):
        return TF.forward(params, cfg, batch["tokens"],
                          embeds=embeds(params, batch), mlp=mlp)

    def init_cache(batch_size, max_len):
        return TF.init_cache(cfg, batch_size, max_len, dev)

    def prefill(params, batch, cache, return_logits=True):
        return TF.prefill(params, cfg, batch["tokens"], cache,
                          batch["prompt_lens"], return_logits=return_logits,
                          embeds=embeds(params, batch), mlp=mlp_no_aux)

    def prefill_packed(params, batch, cache, return_logits=True):
        return TF.prefill(params, cfg, batch["tokens"], cache,
                          batch["prompt_lens"], seg_ids=batch["seg_ids"],
                          positions=batch["positions"],
                          return_logits=return_logits, mlp=mlp_no_aux)

    def decode_step_paged(params, token, pool, block_tables, kv_len, **kw):
        return TF.decode_step_paged(params, cfg, token, pool, block_tables,
                                    kv_len, **kw)

    def decode_step(params, token, cache, kv_len, **kw):
        return TF.decode(params, cfg, token, cache, kv_len, mlp=mlp_no_aux,
                         **kw)

    # vlm prepends stub patch rows to each prompt, which the packed
    # layout's contiguous segments cannot hold (the reference's reason)
    return Model(cfg, dev, init_params, forward, init_cache, prefill,
                 None if ep_mesh is not None else decode_step_paged,
                 None if vlm else prefill_packed, decode_step,
                 prefill_extra=cfg.num_stub_positions if vlm else 0)


def _build_audio(cfg: ModelConfig, dev: torch.device) -> Model:
    def forward(params, batch):
        return (WH.forward(params, cfg, batch["tokens"], batch["frames"]),
                dict(TF.ZERO_AUX))

    def prefill(params, batch, cache, return_logits=True):
        return WH.prefill(params, cfg, batch["tokens"], cache,
                          batch["prompt_lens"], frames=batch.get("frames"),
                          return_logits=return_logits)

    def decode_step(params, token, cache, kv_len, **kw):
        if kw.get("return_hidden"):
            raise ValueError("return_hidden: the audio family has none")
        return WH.decode_step(params, cfg, token, cache, kv_len)

    return Model(cfg, dev, lambda g: WH.init_params(cfg, g, dev), forward,
                 lambda b, m: WH.init_cache(cfg, b, m, dev), prefill,
                 None, None, decode_step)


def _build_recurrent(cfg: ModelConfig, dev: torch.device) -> Model:
    """Zamba2 (``hybrid``) or xLSTM (``ssm``): left padding, the dense
    layout, no packed prefill, no paged decode."""
    mod = HY if cfg.family == "hybrid" else XL

    def forward(params, batch):
        return mod.forward(params, cfg, batch["tokens"]), dict(TF.ZERO_AUX)

    def prefill(params, batch, cache, return_logits=True):
        return mod.prefill(params, cfg, batch["tokens"], cache,
                           batch["prompt_lens"], return_logits=return_logits)

    def decode_step(params, token, cache, kv_len, **kw):
        if kw.get("return_hidden"):
            raise ValueError(f"return_hidden: the {cfg.family} family has "
                             "none")
        if cfg.family == "hybrid":
            return HY.decode_step(params, cfg, token, cache, kv_len,
                                  kv_start=kw.get("kv_start"))
        return XL.decode_step(params, cfg, token, cache, kv_len)

    return Model(cfg, dev, lambda g: mod.init_params(cfg, g, dev), forward,
                 lambda b, m: mod.init_cache(cfg, b, m, dev), prefill,
                 None, None, decode_step, padding_side="left")


def supports_paging(model: Model) -> bool:
    """Paged layout needs right padding and a plain {k, v} cache, as in
    the reference: the local/global pattern's and whisper's four-key
    caches cannot be paged."""
    if model.padding_side != "right":
        return False
    return set(model.init_cache(1, 1)) == {"k", "v"}


# ---------------------------------------------------------------------------
# input_specs / cache_specs: shape stand-ins for the launch path's fit
# report (tensors on the meta device, which hold no storage)
# ---------------------------------------------------------------------------

META = torch.device("meta")


def input_specs(cfg: ModelConfig, seq_len: int, batch: int, kind: str
                ) -> Dict[str, torch.Tensor]:
    """The batch dict as meta tensors, the reference's keys, shapes and
    dtypes (its ``ShapeDtypeStruct`` stand-ins).

    train  : RL update-step inputs (tokens, loss_mask, advantages, old_logprobs)
    prefill: prompt batch
    decode : one-token step inputs (token, kv_len); the cache comes from
             :func:`cache_specs`.
    """
    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)
    i32, f32 = torch.int32, torch.float32
    if kind == "train":
        specs = {
            "tokens": sds((batch, seq_len), i32),
            "loss_mask": sds((batch, seq_len), f32),
            "advantages": sds((batch, seq_len), f32),
            "old_logprobs": sds((batch, seq_len), f32),
        }
    elif kind == "prefill":
        specs = {
            "tokens": sds((batch, seq_len), i32),
            "prompt_lens": sds((batch,), i32),
        }
    elif kind == "decode":
        specs = {
            "token": sds((batch,), i32),
            "kv_len": sds((batch,), i32),
        }
    else:
        raise ValueError(kind)
    if cfg.family == "vlm" and kind != "decode":
        specs["patch_embeds"] = sds(
            (batch, cfg.num_stub_positions, cfg.d_model), torch.bfloat16)
    if cfg.family == "audio" and kind != "decode":
        specs["frames"] = sds(
            (batch, cfg.num_stub_positions, cfg.d_model), torch.bfloat16)
    return specs


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """The cache dict as meta tensors: ``init_cache`` on the meta device
    (no allocation)."""
    return build_model(cfg, device=META).init_cache(batch, max_len)
