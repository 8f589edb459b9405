"""Logical-axis sharding on one device (counterpart of
``repro/distributed/sharding.py``).

The reference's models annotate activations with logical axis names, and
an installed rule set maps them to the axes of a device mesh; its
trainer pads an update batch to the data shards' count and places one
equal slice on each.  The port runs on one card, so placement means
nothing: ``axis_rules`` records the mesh and rules for the enclosed
region, ``logical_constraint`` returns its input, and
``shard_update_batch`` only pads (inside a context) to the count that
``data_shard_count`` reads from the mesh's axis sizes (a ``LocalMesh``'s
``shape`` dict or a ``DeviceMesh``'s names and shape).  Outside any
context every function is the identity, as in the reference.

Left out, because they mean nothing on one device: ``logical_to_spec``,
``train_rules``, ``decode_rules`` and every ``NamedSharding`` placement.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import axis_sizes

_state = threading.local()


def _current() -> Optional[Tuple[object, Dict[str, object]]]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, object]):
    """Install (mesh, logical -> mesh-axis rules) for the enclosed region.
    ``mesh`` is a ``LocalMesh`` or a ``DeviceMesh`` (``launch/mesh.py``);
    ``rules`` maps a logical axis name to a mesh axis name, a tuple of
    them, or None (replicated)."""
    prev = _current()
    _state.ctx = (mesh, dict(rules))
    try:
        yield
    finally:
        _state.ctx = prev


def logical_constraint(x, logical: Sequence[Optional[str]]):
    """The reference's sharding constraint by logical axis names: ``x``
    unchanged (one device holds every shard)."""
    return x


def data_shard_count() -> int:
    """Total mesh extent the logical ``batch`` axis maps to under the
    installed rules: the number of equal slices an update batch is split
    into.  1 outside any context."""
    ctx = _current()
    if ctx is None:
        return 1
    mesh, rules = ctx
    sizes = axis_sizes(mesh)
    spec = rules.get("batch")
    axes = spec if isinstance(spec, (tuple, list)) else (spec,)
    size = 1
    for a in axes:
        if a is not None:
            size *= sizes[a]
    return size


def pad_update_batch(batch: Dict[str, object], multiple: int,
                     pad_token: int = 0) -> Dict[str, object]:
    """Pad the leading (batch) dim of every array up to a multiple, for
    torch tensors (on their device, in their dtype) and numpy arrays.

    Pad rows are inert: ``tokens`` rows are all ``pad_token`` and every
    other array is zero, so they contribute nothing to the loss (call it
    after the advantages, so batch statistics see only real rows)."""
    if multiple <= 1:
        return batch
    B = next(iter(batch.values())).shape[0]
    extra = (-B) % multiple
    if extra == 0:
        return batch
    out = {}
    for key, x in batch.items():
        fill_value = pad_token if key == "tokens" else 0
        shape = (extra,) + tuple(x.shape[1:])
        if isinstance(x, torch.Tensor):
            fill = torch.full(shape, fill_value, dtype=x.dtype,
                              device=x.device)
            out[key] = torch.cat([x, fill], dim=0)
        else:
            x = np.asarray(x)
            fill = np.full(shape, fill_value, dtype=x.dtype)
            out[key] = np.concatenate([x, fill], axis=0)
    return out


def shard_update_batch(batch: Dict[str, object],
                       pad_token: int = 0) -> Dict[str, object]:
    """The update batch padded to a multiple of :func:`data_shard_count`
    with inert rows (:func:`pad_update_batch`) inside an
    :func:`axis_rules` context, and left where it is (one device); the
    batch itself outside any context."""
    if _current() is None:
        return batch
    return pad_update_batch(batch, data_shard_count(), pad_token)
