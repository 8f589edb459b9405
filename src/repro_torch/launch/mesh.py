"""Meshes and hardware constants of the launch path (counterpart of
``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over an
initialised process group (``make_compat_mesh``, ``make_production_mesh``:
the reference's (16, 16) and (2, 16, 16) pod meshes at worlds of 256 and
512 ranks), or the :class:`LocalMesh` stand-in of one device for callers
with no process group (``make_local_mesh``).  Both kinds name their axes
``"data"`` and ``"model"`` (and ``"pod"``); :func:`axis_size` and
:func:`axis_group` read either.  On a ``DeviceMesh`` the dense family's
steps hold each tensor as its plan's specs place it (``launch/steps.py``,
``launch/plans.py`` ``place``/``gather``); the MoE family's steps cut its
experts and replicate the rest.

Functions, not module constants: importing this module touches no device
and no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The reference's 1x1 ``("data", "model")`` mesh: axis name -> size."""
    shape: Dict[str, int]


def make_local_mesh() -> LocalMesh:
    """1-device mesh with the production axis names."""
    return LocalMesh({"data": 1, "model": 1})


def make_compat_mesh(shape: Sequence[int], axes: Sequence[str],
                     device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    initialised world (its size must be ``prod(shape)``), on ``cuda``
    unless the caller asks for ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_compat_mesh: no process group is initialised; call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"make_compat_mesh: a {tuple(shape)} mesh needs "
                         f"{math.prod(shape)} ranks, the world has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, over a world of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = dist.get_world_size() if (dist.is_available()
                                      and dist.is_initialized()) else 1
    if world != math.prod(shape):
        raise ValueError(
            f"make_production_mesh: the {shape} pod mesh needs "
            f"{math.prod(shape)} ranks; the world has {world}")
    return make_compat_mesh(shape, axes, device_type)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, of a ``DeviceMesh`` (a tuple ``shape`` beside
    its ``mesh_dim_names``) or of a ``LocalMesh`` or any mesh whose
    ``shape`` maps names to sizes."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return axis_sizes(mesh)[axis]


def axis_group(mesh, axis: str) -> Optional[dist.ProcessGroup]:
    """The process group of ``axis`` of a ``DeviceMesh``; None on a
    ``LocalMesh`` (one device, no group)."""
    return mesh.get_group(axis) if is_device_mesh(mesh) else None


def is_device_mesh(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh)


# NVIDIA H100 SXM (per card; NVIDIA's data sheet, dense rates at the full
# 700 W power limit): the fit report's roofline denominators and memory.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12                # bytes/s, HBM3
HBM_BYTES = 80e9                # bytes
