"""Checkpointing (counterpart of ``repro/train/checkpoint.py``): a flat
``.npz`` of the (params, opt_state) trees plus a JSON manifest, in the
reference's format, so that a checkpoint written by either package
restores into the other.

Keys are the reference's path encoding: ``p/<dict path>`` for
parameters, ``o/.step``, ``o/.m/<path>`` and ``o/.v/<path>`` for the
optimizer state (jax names a NamedTuple field ``.name``).  bf16 tensors
are stored as f32 arrays (exact; numpy has no bf16 of its own, as in
``repro_torch.convert.to_numpy``) and cast back on restore.  The
reference stores its bf16 leaves as raw 2-byte records (numpy ``V2``);
``restore`` reads those bit for bit too.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.train.optimizer import OptState


def _walk(tree: Any, prefix: str = ""):
    """(key, leaf) pairs of a nested dict / OptState, keys as the
    reference writes them."""
    if isinstance(tree, OptState):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), f"{prefix}.{name}/")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # the reference's bf16 leaf: the upper half of an f32's bits
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        return torch.from_numpy(bits.view(np.float32).copy())
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True))


def save(path: str, params: Any, opt_state: Any = None,
         meta: Dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"p/{k}": _to_numpy(v) for k, v in _walk(params)}
    if opt_state is not None:
        arrays.update({f"o/{k}": _to_numpy(v) for k, v in _walk(opt_state)})
    np.savez(path, **arrays)
    with open(path + ".json", "w") as f:
        json.dump({"meta": meta or {},
                   "dtypes": {k: str(v.dtype) for k, v in arrays.items()}},
                  f)


def restore(path: str, params_template: Any,
            opt_template: Any = None) -> Tuple[Any, Any]:
    """Trees shaped like the templates, each leaf on its template's device
    and in its dtype."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        def rebuild(tree, prefix):
            if isinstance(tree, OptState):
                return OptState(*(rebuild(getattr(tree, n),
                                          f"{prefix}.{n}/")
                                  for n in tree._fields))
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{prefix}{k}/")
                        for k, v in tree.items()}
            key = prefix[:-1]
            t = _from_numpy(data[key]).to(device=tree.device,
                                          dtype=tree.dtype)
            assert t.shape == tree.shape, (key, t.shape, tree.shape)
            return t

        params = rebuild(params_template, "p/")
        opt = (rebuild(opt_template, "o/") if opt_template is not None
               else None)
    return params, opt
