"""Meshes and hardware constants of the launch path (counterpart of
``repro/launch/mesh.py``).

The port runs on one card.  ``make_local_mesh`` is the one-device
stand-in that ``repro_torch.distributed.sharding.axis_rules`` takes (it
reads only ``.shape``); ``make_production_mesh`` has nothing to build
until the port has a multi-card target.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """The reference's 1x1 ``("data", "model")`` mesh: axis name -> size."""
    shape: Dict[str, int]


def make_local_mesh() -> LocalMesh:
    """1-device mesh with the production axis names."""
    return LocalMesh({"data": 1, "model": 1})


def make_production_mesh(*, multi_pod: bool = False):
    raise NotImplementedError(
        "one card has no pod mesh: the reference's (16, 16) and (2, 16, 16) "
        "meshes wait for a multi-card target of the port")


# NVIDIA H100 SXM (per card; NVIDIA's data sheet, dense rates at the full
# 700 W power limit): the fit report's roofline denominators and memory.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores, dense
HBM_BW = 3.35e12                # bytes/s, HBM3
HBM_BYTES = 80e9                # bytes
