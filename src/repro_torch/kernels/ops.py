"""Public kernel entry points (counterpart of ``repro/kernels/ops.py``).

Dispatch follows the tensors' device: CPU tensors take the plain PyTorch
version, CUDA tensors launch the hand-written kernel or raise; there is no
fallback from CUDA to the plain version.  Meta tensors (shapes only, for
the launch path's fit report) take the plain version too.  Each kernel module counts its
launches by kernel name (the paged module counts fp and int8 pages
apart); ``launch_counts``/``reset_launch_counts`` read and clear them.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import fused_sample as _fs
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_decode_attention as _pd
from repro_torch.kernels import ragged_decode_attention as _rd
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.fused_sample import fused_sample  # noqa: F401
from repro_torch.kernels.paged_decode_attention import (  # noqa: F401
    paged_decode_attention, paged_decode_attention_int8)
from repro_torch.kernels.ragged_decode_attention import (  # noqa: F401
    ragged_decode_attention)

KERNEL_MODULES = (_pd, _rd, _fa, _fs)


def launch_counts() -> Dict[str, int]:
    return {k: n for m in KERNEL_MODULES for k, n in m.launches.items()}


def reset_launch_counts() -> None:
    for m in KERNEL_MODULES:
        for k in m.launches:
            m.launches[k] = 0
