"""Fused LM head + top-k + logsumexp: wrapper of ``csrc/fused_sample.cu``.

Replaces the Pallas TPU kernel ``fused_sample`` (``_fused_sample_kernel``)
in ``repro/kernels/ragged_decode_attention.py``.  Bound on the H100:
bytes, the head W (Dm x V) read once per decode step (311 MB for
Qwen3-0.6B in bf16, ~93 us at 3.35 TB/s).  The bf16 kernel streams W
once: one persistent CTA per SM walks 128-wide vocab chunks through a
4-tile ``cp.async`` ring, multiplies on the tensor cores
(``mma.sync``) against x staged once per CTA, and carries a running
logsumexp and top-k per row across its chunks; a second pass merges one
partial per CTA, lowest index first on ties.  A head too wide to stage x
whole (Qwen1.5-110B's Dm = 8192, Nemotron-4-340B's 18432) streams x
through the same ring, a slice beside each W tile.  f32 (test shapes) keeps
FMAs and one partial per chunk.  W is read through its strides, so a
tied head passes ``embed.T`` and is never transposed in memory.  See the
source.

CPU tensors take the plain version (``ref.fused_sample_ref``); CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_sample_ref

NAME = "fused_sample"
launches = {NAME: 0}    # kernel launches since the last reset
_lib = None


def _bind():
    global _lib
    if _lib is None:
        lib = build.load(NAME)
        fn = lib.fused_sample
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_sample_max_k.argtypes = []
        lib.fused_sample_partials.argtypes = [ctypes.c_int] * 2
        lib.fused_sample_bf16_plan.argtypes = [ctypes.c_int] * 3
        for fn in (lib.fused_sample_max_k, lib.fused_sample_partials,
                   lib.fused_sample_bf16_plan):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def bf16_plan(B: int, Dm: int, top_k: int = 1):
    """(rows a CTA of the bf16 kernel takes, whether x streams through its
    ring instead of being staged whole) at these shapes (builds the
    library)."""
    rows = _bind().fused_sample_bf16_plan(B, Dm, top_k)
    return abs(rows), rows < 0


def fused_sample(x, w, top_k: int = 1, softcap: float = 0.0):
    """x (B, Dm); w (Dm, V) read through its strides (a tied head passes
    embed.T; in bf16 one stride must be 1 and the other a multiple of 8).

    Returns (vals (B, top_k) f32, idx (B, top_k) int32, lse (B, 1) f32):
    the top-k softcapped logits, their vocab indices (lowest first on
    ties) and the logsumexp over the whole vocab."""
    if build.takes_plain(x, w):
        return fused_sample_ref(x, w, top_k=top_k, softcap=softcap)
    dev = build.require_cuda(NAME, x, w)
    code = build.dtype_code(NAME, x, w)
    B, Dm = x.shape
    build.require(w.dim() == 2 and w.shape[0] == Dm, NAME,
                  f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    V = w.shape[1]
    build.require(x.is_contiguous(), NAME, "x must be contiguous")
    build.require(min(w.stride()) >= 1, NAME, "w strides must be positive")
    lib = _bind()
    build.require(1 <= top_k <= min(V, lib.fused_sample_max_k()), NAME,
                  f"top_k must be in [1, {lib.fused_sample_max_k()}] and "
                  f"<= V, got {top_k}")
    if code == build.DTYPE_CODES[torch.bfloat16]:
        sd, sv = w.stride()
        build.require((sd == 1 and sv % 8 == 0) or (sv == 1 and sd % 8 == 0),
                      NAME, f"bf16 w needs one unit stride and the other a "
                      f"multiple of 8, got strides {w.stride()}")
        build.require(Dm % 8 == 0 and x.data_ptr() % 16 == 0
                      and w.data_ptr() % 16 == 0, NAME,
                      "bf16 needs Dm % 8 == 0 and 16-byte aligned x and w")
    vals = torch.empty((B, top_k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, top_k), dtype=torch.int32, device=dev)
    lse = torch.empty((B, 1), dtype=torch.float32, device=dev)
    if B == 0:
        return vals, idx, lse
    nc = lib.fused_sample_partials(V, code)
    pmax = torch.empty((B, nc), dtype=torch.float32, device=dev)
    psum = torch.empty((B, nc), dtype=torch.float32, device=dev)
    ptv = torch.empty((B, nc, top_k), dtype=torch.float32, device=dev)
    pti = torch.empty((B, nc, top_k), dtype=torch.int32, device=dev)
    rc = lib.fused_sample(
        x.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
        vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), pmax.data_ptr(),
        psum.data_ptr(), ptv.data_ptr(), pti.data_ptr(), B, Dm, V, top_k,
        float(softcap), code, build.stream_ptr(dev))
    build.check(rc, NAME)
    launches[NAME] += 1
    return vals, idx, lse
