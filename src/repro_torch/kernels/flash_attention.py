"""Causal GQA prefill attention: wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``flash_attention`` (``_kernel``) in
``repro/kernels/flash_attention.py``.  Bound on the H100: operations, the
causal flops over the bf16 tensor-core peak (989 TFLOP/s).  The bf16
kernel puts both products on the tensor cores (``mma.sync.m16n8k16``,
bf16 operands, f32 accumulators, P rounded to bf16 for P V), streams
64-row K/V tiles through a two-stage ``cp.async`` ring, applies masks
and softcap on the score fragments in registers and keeps the online
softmax in f32; it visits only the tiles inside the causal range and
the window, heaviest query tiles first, and masks a ragged S where the
TPU kernel asserted S % 128 == 0.  f32 keeps an f32 FMA kernel (TF32
would not hold its tolerance).  See the source.

CPU tensors take the plain version (``ref.flash_attention_ref``); CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

NAME = "flash_attention"
launches = {NAME: 0}    # kernel launches since the last reset
_fn = None


def _bind():
    global _fn
    if _fn is None:
        fn = build.load(NAME).flash_attention
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q, k, v, seg_ids=None, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, D); k/v (B, S, Kh, D) -> (B, S, H, D), causal.

    ``seg_ids`` (B, S) int32: packed prefill; a query attends only keys of
    its own segment id (pad columns carry -1 and match each other, so
    their rows are garbage the caller discards)."""
    if build.all_on_cpu(q, k, v, seg_ids):
        return flash_attention_ref(q, k, v, causal=True, window=window,
                                   softcap=softcap, seg_ids=seg_ids)
    dev = build.require_cuda(NAME, q, k, v, seg_ids)
    code = build.dtype_code(NAME, q, k, v)
    B, S, H, D = q.shape
    Kh = k.shape[2]
    build.require(k.shape == (B, S, Kh, D) and v.shape == k.shape, NAME,
                  f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q "
                  f"{tuple(q.shape)}")
    build.require(H % Kh == 0 and (D in (64, 128)
                                   or (D == 32 and q.dtype == torch.float32)),
                  NAME, f"needs H % Kh == 0 and D in (64, 128) (or 32 in "
                  f"f32); got H={H} Kh={Kh} D={D} {q.dtype}")
    build.require(window >= 0, NAME, f"window must be >= 0, got {window}")
    build.require(all(t.is_contiguous() for t in (q, k, v)), NAME,
                  "q, k, v must be contiguous")
    if seg_ids is not None:
        build.require(seg_ids.shape == (B, S) and seg_ids.dtype == torch.int32
                      and seg_ids.is_contiguous(), NAME,
                      "seg_ids must be a contiguous (B, S) int32 tensor")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    rc = _bind()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if seg_ids is None else seg_ids.data_ptr(),
                 out.data_ptr(), B, S, H, Kh, D, int(window), float(softcap),
                 code, build.stream_ptr(dev))
    build.check(rc, NAME)
    launches[NAME] += 1
    return out
