"""Per-(architecture x shape) execution plans (counterpart of
``repro/launch/plans.py``): sharding strategy, remat, microbatching,
optimizer-state dtype, decode-cache layout.

The tables are the reference's, entry for entry, with its divisibility
test against the production mesh's 16 (a dim 16 does not divide stays
replicated, whatever the mesh).  Where the reference returns a
``PartitionSpec``, this module returns a tuple of mesh-axis names (None:
replicated; a tuple of names: split over those axes, outermost first),
one entry a dim.  :func:`place` cuts a tree by its specs to the blocks a
rank of a ``DeviceMesh`` holds (those of the reference's
``NamedSharding`` at the rank's mesh coordinates) and :func:`gather`
gathers them back; on a ``LocalMesh`` both are the identity.

Strategies
----------
* ``dp``   - pure data parallel: batch over (data, model); params replicated.
* ``tp``   - Megatron tensor parallel over `model` (+ sequence-parallel
  residual stream) with FSDP parameter/optimizer sharding over `data`.
* decode cache: ``kvheads`` shards the KV-head axis over `model`;
  ``seqshard`` shards the cache sequence axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import entry_axes

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class Plan:
    strategy: str = "tp"            # dp | tp
    fsdp: bool = True               # shard params/opt over data (tp only)
    seq_parallel: bool = True       # residual stream seq over model (tp only)
    remat: bool = True
    microbatches: int = 1
    opt_dtype: Any = torch.float32
    decode_cache: str = "kvheads"   # kvheads | seqshard
    # long_500k only: shard cache seq over both axes
    cache_seq_axes: Tuple[str, ...] = ("model",)
    # decode-only: 2D tensor-parallel serving (activations replicated over
    # `data`, data-sharded weight dims contracted locally)
    decode_2d: bool = False


def _dense_plan(big: bool = False, micro: int = 1) -> Plan:
    return Plan(strategy="tp", fsdp=True, seq_parallel=True, remat=True,
                microbatches=micro,
                opt_dtype=torch.bfloat16 if big else torch.float32)


PLANS: Dict[Tuple[str, str], Plan] = {}


def _set(arch: str, shape: str, plan: Plan) -> None:
    PLANS[(arch, shape)] = plan


# -- small archs: pure DP ----------------------------------------------------
for _a in ("xlstm_125m", "whisper_small", "qwen3_0_6b"):
    _set(_a, "train_4k", Plan(strategy="dp", fsdp=False, seq_parallel=False,
                              remat=True, microbatches=1))
    _set(_a, "prefill_32k", Plan(strategy="dp", fsdp=False,
                                 seq_parallel=False, remat=False))
    _set(_a, "decode_32k", Plan(strategy="dp", fsdp=False,
                                seq_parallel=False, remat=False,
                                decode_cache="seqshard"))
    _set(_a, "long_500k", Plan(strategy="dp", fsdp=False, seq_parallel=False,
                               remat=False, decode_cache="seqshard",
                               cache_seq_axes=("data", "model")))

# -- medium TP archs ---------------------------------------------------------
for _a in ("gemma2_2b", "zamba2_1_2b", "granite_moe_3b_a800m",
           "phi_3_vision_4_2b"):
    _set(_a, "train_4k", _dense_plan(micro=4))
    _set(_a, "prefill_32k", _dense_plan())
_set("gemma2_2b", "decode_32k", Plan(decode_cache="seqshard", remat=False))
_set("gemma2_2b", "long_500k", Plan(decode_cache="seqshard", remat=False,
                                    cache_seq_axes=("data", "model")))
_set("zamba2_1_2b", "decode_32k", Plan(decode_cache="kvheads", remat=False))
_set("zamba2_1_2b", "long_500k", Plan(decode_cache="seqshard", remat=False,
                                      cache_seq_axes=("data",)))
_set("granite_moe_3b_a800m", "decode_32k", Plan(decode_cache="seqshard",
                                                remat=False))
_set("phi_3_vision_4_2b", "decode_32k", Plan(decode_cache="kvheads",
                                             remat=False))

# -- big archs: TP + FSDP + SP + remat + microbatches + bf16 opt -------------
_set("qwen1_5_110b", "train_4k", _dense_plan(big=True, micro=4))
_set("qwen1_5_110b", "prefill_32k", _dense_plan(big=True))
_set("qwen1_5_110b", "decode_32k", Plan(decode_cache="seqshard", remat=False,
                                        opt_dtype=torch.bfloat16,
                                        decode_2d=True))
_set("nemotron_4_340b", "train_4k", _dense_plan(big=True, micro=8))
_set("nemotron_4_340b", "prefill_32k", _dense_plan(big=True))
_set("nemotron_4_340b", "decode_32k", Plan(decode_cache="seqshard",
                                           remat=False,
                                           opt_dtype=torch.bfloat16,
                                           decode_2d=True))
_set("qwen3_moe_235b_a22b", "train_4k", _dense_plan(big=True, micro=4))
_set("qwen3_moe_235b_a22b", "prefill_32k", _dense_plan(big=True))
_set("qwen3_moe_235b_a22b", "decode_32k", Plan(decode_cache="seqshard",
                                               remat=False,
                                               opt_dtype=torch.bfloat16,
                                               decode_2d=True))
# qwen3-0.6b prefill at batch 32 goes tensor parallel (the reference's HC1)
_set("qwen3_0_6b", "prefill_32k", _dense_plan())
_set("qwen3_0_6b", "decode_32k", Plan(strategy="dp", fsdp=False,
                                      seq_parallel=False, remat=False,
                                      decode_cache="seqshard"))

# Pairs intentionally absent (long_500k on pure full-attention archs).
SKIPS: Dict[Tuple[str, str], str] = {
    ("qwen3_moe_235b_a22b", "long_500k"): "full attention, no windowed variant",
    ("qwen3_0_6b", "long_500k"): "full attention, no windowed variant",
    ("nemotron_4_340b", "long_500k"): "full attention, no windowed variant",
    ("qwen1_5_110b", "long_500k"): "full attention, no windowed variant",
    ("granite_moe_3b_a800m", "long_500k"): "full attention, no windowed variant",
    ("phi_3_vision_4_2b", "long_500k"): "full attention, no windowed variant",
    ("whisper_small", "long_500k"): "decoder max position 1.5k; 500k decode meaningless",
}
for _k in SKIPS:
    PLANS.pop(_k, None)


def get_plan(arch: str, shape: str) -> Optional[Plan]:
    if (arch, shape) in SKIPS:
        return None
    return PLANS[(arch, shape)]


# ---------------------------------------------------------------------------
# Parameter specs by tree path
# ---------------------------------------------------------------------------

def _n_lead(top: str, cfg: ModelConfig) -> int:
    """Leading layer-stack dims of a top-level parameter group."""
    from repro_torch.models.transformer import pattern_len
    if top == "layers":
        return pattern_len(cfg)
    if top == "mamba_main":
        return 2
    if top in ("mamba_tail", "enc_layers", "dec_layers", "mlstm", "slstm"):
        return 1
    return 0


def _core_spec(path: str, shape: Tuple[int, ...], plan: Plan,
               cfg: ModelConfig) -> Spec:
    """Spec entries for the non-stacked dims of one leaf."""
    fs = "data" if (plan.fsdp and plan.strategy == "tp") else None
    M = "model" if plan.strategy == "tp" else None
    leaf = path.split("/")[-1]
    group = path.split("/")[0]

    if group == "embed":
        if cfg.tie_embeddings:
            return (M, None)           # vocab over model (used as lm head)
        return (None, M)               # d over model: cheap input gather
    if group == "lm_head":
        return (fs, M)                 # vocab over model
    if group == "pos_embed":
        return (None, None)
    if leaf in ("wq", "wk", "wv"):
        return (fs, M, None)
    if leaf == "wo":
        return (M, None, fs)
    if leaf in ("bq", "bk", "bv"):
        return (M, None)
    if leaf in ("q_norm", "k_norm"):
        return (None,)
    if leaf in ("w_in", "w_gate", "w_out") and len(shape) == 3:   # MoE expert
        return (M, fs, None) if leaf != "w_out" else (M, None, fs)
    if leaf in ("w_in", "w_gate"):
        return (fs, M)
    if leaf == "w_out":
        return (M, fs)
    if leaf == "router":
        return (None, None)
    # mamba2
    if leaf in ("in_z", "in_x", "in_dt"):
        return (fs, M)
    if leaf == "in_bc":
        return (fs, None)
    if leaf == "conv_x_w":
        return (None, M)
    if leaf == "conv_x_b":
        return (M,)
    if leaf in ("conv_bc_w", "conv_bc_b"):
        return (None,) * len(shape)
    if leaf in ("A_log", "dt_bias", "D"):
        return (M,)
    if leaf == "gate_norm":
        return (M,)
    if leaf == "out_proj":
        return (M, fs)
    # xlstm / norms / everything else: replicated
    return (None,) * len(shape)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(params_shape, cfg: ModelConfig, plan: Plan):
    """Parameter tree (tensors, meta or real) -> tree of spec tuples."""

    def spec_for(parts, leaf):
        top = parts[0]
        n_lead = _n_lead(top, cfg)
        shape = tuple(leaf.shape)
        core = _core_spec("/".join([top, parts[-1]]), shape[n_lead:], plan,
                          cfg)
        full = (None,) * n_lead + tuple(core)
        if len(full) != len(shape):
            raise ValueError(f"{'/'.join(parts)}: spec {full} for shape "
                             f"{shape}")
        # axes that do not divide the dim evenly -> replicate that dim
        return tuple(None if ax is None or dim % {"data": 16, "model": 16}
                     .get(ax, 1) else ax for dim, ax in zip(shape, full))

    return _map_with_path(spec_for, params_shape)


# ---------------------------------------------------------------------------
# Activation logical-axis rules per plan
# ---------------------------------------------------------------------------

def activation_rules(plan: Plan, multi_pod: bool, kind: str) -> Dict[str, Any]:
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    if plan.decode_2d and kind == "decode" and plan.strategy == "tp":
        return {
            "batch": ("pod",) if multi_pod else None,
            "seq": None, "seq_attn": None, "seq_out": None,
            "embed": "data",
            "heads": "model", "kv_heads": "model", "head_dim": None,
            "ffn": "model", "vocab": "model", "experts": "model",
            "ssm_heads": "model", "ssm_state": None,
            "fsdp": "data" if plan.fsdp else None,
            "cache_seq": None,
        }
    if plan.strategy == "dp":
        rules = {k: None for k in
                 ("seq", "seq_attn", "seq_out", "embed", "heads", "kv_heads",
                  "head_dim", "ffn", "vocab", "experts", "ssm_heads",
                  "ssm_state", "cache_seq")}
        rules["batch"] = batch_axes + ("model",)
        rules["fsdp"] = None
        return rules
    return {
        "batch": batch_axes,
        "seq": "model" if (plan.seq_parallel and kind == "train") else None,
        "seq_attn": None,
        "seq_out": None,
        "embed": None,
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "ffn": "model",
        "vocab": "model",
        "experts": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "fsdp": "data" if plan.fsdp else None,
        "cache_seq": None,
    }


# ---------------------------------------------------------------------------
# Cache specs (decode shapes)
# ---------------------------------------------------------------------------

# cache leaf layouts: name -> (batch_axis_index, seq_axis_index or None,
#                              kvhead_axis_index or None)
CACHE_LAYOUT = {
    "k": (1, 2, 3), "v": (1, 2, 3),
    "k_local": (1, 2, 3), "v_local": (1, 2, 3),
    "k_global": (1, 2, 3), "v_global": (1, 2, 3),
    "k_x": (1, 2, 3), "v_x": (1, 2, 3),
    "attn_k": (1, 2, 3), "attn_v": (1, 2, 3),
    "ssm_main": (2, None, None), "conv_x_main": (2, None, None),
    "conv_bc_main": (2, None, None),
    "ssm_tail": (1, None, None), "conv_x_tail": (1, None, None),
    "conv_bc_tail": (1, None, None),
    "mlstm_C": (1, None, None), "mlstm_n": (1, None, None),
    "mlstm_conv": (1, None, None),
    "slstm_c": (1, None, None), "slstm_n": (1, None, None),
    "slstm_h": (1, None, None), "slstm_m": (1, None, None),
}
_AXIS = {"pod": 2, "data": 16, "model": 16}


def cache_specs_for(cache_shape, cfg: ModelConfig, plan: Plan,
                    batch: int, multi_pod: bool):
    """Cache tree (tensors, meta or real) -> tree of spec tuples."""
    batch_axes = ("pod", "data") if multi_pod else ("data",)
    n_model = 16

    def spec_for(parts, leaf):
        b_ax, s_ax, kh_ax = CACHE_LAYOUT[parts[-1]]
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if shape[b_ax] % (16 * (2 if multi_pod else 1)) == 0:
            spec[b_ax] = batch_axes if len(batch_axes) > 1 else batch_axes[0]
        elif multi_pod and shape[b_ax] % 2 == 0 \
                and plan.decode_cache == "seqshard":
            spec[b_ax] = "pod"
        elif shape[b_ax] % 16 == 0:
            spec[b_ax] = "data"
        if s_ax is not None:
            if plan.decode_cache == "seqshard":
                used = spec[b_ax]
                used = (used if isinstance(used, tuple)
                        else (used,) if used else ())
                axes = tuple(a for a in plan.cache_seq_axes if a not in used)
                if multi_pod and "pod" not in used and "pod" not in axes \
                        and spec[b_ax] is None:
                    axes = ("pod",) + axes
                size = 1
                for a in axes:
                    size *= _AXIS[a]
                if axes and shape[s_ax] % size == 0:
                    spec[s_ax] = axes if len(axes) > 1 else axes[0]
            elif kh_ax is not None and plan.decode_cache == "kvheads" \
                    and shape[kh_ax] % n_model == 0:
                spec[kh_ax] = "model"
        return tuple(spec)

    return _map_with_path(spec_for, cache_shape)


# ---------------------------------------------------------------------------
# Placement: a tree cut to a rank's blocks by its specs, and back
# ---------------------------------------------------------------------------


def _map_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree (dicts, named tuples such as
    ``OptState``) and its spec tree of the same structure."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*[_map_specs(fn, t, s)
                            for t, s in zip(tree, specs)])
    return fn(tree, tuple(specs))


def block(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The rank's block of the whole tensor ``x`` under ``spec`` on
    ``mesh`` (a new contiguous tensor; ``x`` itself on a ``LocalMesh``):
    each dim split over its axes, outermost first."""
    from repro_torch.launch.mesh import axis_sizes, is_device_mesh
    if not is_device_mesh(mesh):
        return x
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    for dim, entry in enumerate(spec):
        n, i = 1, 0
        for a in entry_axes(entry):
            n, i = n * sizes[a], i * sizes[a] + mesh.get_local_rank(a)
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"place: {n} blocks do not divide dim "
                                 f"{dim} of {tuple(x.shape)} ({spec})")
            w = x.shape[dim] // n
            x = x.narrow(dim, i * w, w)
    return x.contiguous()


def place(tree, specs, mesh):
    """Every leaf of ``tree`` (whole tensors, the same on every rank) cut
    to the rank's block by its spec (:func:`block`)."""
    return _map_specs(lambda x, s: block(x, s, mesh), tree, specs)


def gather(tree, specs, mesh):
    """The inverse of :func:`place`: every rank's blocks gathered to the
    whole tensors (the innermost axis of a dim first), on every rank;
    for checkpoints and comparisons.  The identity on a ``LocalMesh``."""
    from repro_torch.distributed import collectives as COL
    from repro_torch.launch.mesh import axis_group, axis_sizes, is_device_mesh
    if not is_device_mesh(mesh):
        return tree
    sizes = axis_sizes(mesh)

    def whole(x, spec):
        for dim, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):
                if sizes[a] > 1:
                    x = torch.cat(COL._gather(x, axis_group(mesh, a)),
                                  dim=dim)
        return x
    return _map_specs(whole, tree, specs)


def spec_leaves(specs) -> list:
    """The spec tuples of a spec tree in ``tree_leaves`` order (sorted
    dict keys), beside the parameters' leaves."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [tuple(specs)]
