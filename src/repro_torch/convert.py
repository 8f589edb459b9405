"""Carry parameters between the reference package and the port.

``from_jax_params`` takes the reference's parameter tree as nested dicts of
numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's side)
and returns the same tree of torch tensors; ``to_numpy`` goes back.  The
trees match key for key, stacked layer axis included, so conversion is a
copy per leaf, and each leaf keeps its own dtype (an MoE tree's f32
router beside its bf16 experts).

bf16 leaves arrive as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; they go through f32 (exact) and are cast
back to ``torch.bfloat16``.  ``to_numpy`` returns bf16 tensors as f32
arrays for the same reason (exact; cast them back with the caller's
numpy bf16 type if needed).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device

_NUMPY_NATIVE = {np.dtype(t) for t in (np.float32, np.float64, np.float16,
                                       np.int32, np.int64, np.int8,
                                       np.uint8, np.bool_)}


def _leaf_to_torch(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if arr.dtype not in _NUMPY_NATIVE:
        raise TypeError(f"unsupported leaf dtype {arr.dtype}")
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)


def from_jax_params(tree: Any, device=None) -> Any:
    """Nested dict of numpy arrays -> the same tree of torch tensors, on
    the card unless the caller passes ``device="cpu"``
    (``repro_torch.resolve_device``)."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _leaf_to_torch(t, dev)
    return walk(tree)


def to_numpy(params: Any) -> Any:
    """Tree of torch tensors -> nested dict of numpy arrays (bf16 as f32)."""
    if isinstance(params, dict):
        return {k: to_numpy(v) for k, v in params.items()}
    t = params.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
