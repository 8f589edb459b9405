"""PyTorch/CUDA port of the ``repro`` rollout engine and RL loop.

The JAX package ``repro`` stays the reference; this package mirrors its
layout (``repro_torch/models/transformer.py`` <-> ``repro/models/
transformer.py``) and imports nothing from it, nor from JAX.  The
hand-written Hopper kernels live in ``repro_torch/kernels`` (sources under
``kernels/csrc``, built on first use into ``build/kernels``).

Entry points (``build_model``, ``SlotEngine``, ``RLSession.from_config``
through ``SessionConfig.device``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without that request they raise
instead of quietly running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; the CPU only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' requested but CUDA is unavailable")
    return device
