"""Paged GQA decode attention: wrapper of ``csrc/paged_decode_attention.cu``.

Replaces the Pallas TPU kernel ``paged_decode_attention`` (``_paged_kernel``
+ ``_flash_decode_block``) in ``repro/kernels/ragged_decode_attention.py``.
Bound on the H100: bytes, the live K/V rows over 3.35 TB/s.  The kernel
reads each live row once: one CTA per (KV head, slot) serves the KV
head's G query heads, warps walk 32-row chunks (two 16-row pages) whose
physical pages the CTA looks up in the block table itself, and the online
softmax stays in f32 registers.  See the source for the details.

CPU tensors take the plain version (``ref.paged_decode_attention_ref``);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_decode_attention_ref

NAME = "paged_decode_attention"
launches = 0            # kernel launches since the last reset
_fn = None


def _bind():
    global _fn
    if _fn is None:
        fn = build.load(NAME).paged_decode_attention
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_len,
                           softcap: float = 0.0, window: int = 0
                           ) -> torch.Tensor:
    """q (B, H, D); k/v_pages (N, P, Kh, D); block_tables (B, nb) int32;
    kv_len (B,) int32 -> (B, H, D).  Rows at or past ``kv_len`` are
    masked; ``kv_len == 0`` gives zeros.  ``window`` is applied by the
    plain version only: the kernel takes none, so a window on CUDA raises
    instead of being ignored."""
    global launches
    args = (q, k_pages, v_pages, block_tables, kv_len)
    if build.all_on_cpu(*args):
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          kv_len, softcap=softcap,
                                          window=window)
    if window:
        raise NotImplementedError(
            f"{NAME}: the CUDA kernel has no sliding window (got {window})")
    dev = build.require_cuda(NAME, *args)
    code = build.dtype_code(NAME, q, k_pages, v_pages)
    B, H, D = q.shape
    N, P, Kh, Dk = k_pages.shape
    nb = block_tables.shape[1]
    build.require(v_pages.shape == k_pages.shape and Dk == D, NAME,
                  f"page shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)}"
                  f" do not match q {tuple(q.shape)}")
    build.require(H % Kh == 0 and H // Kh in (1, 2, 4, 8) and D in (64, 128),
                  NAME, f"needs G in (1, 2, 4, 8), D in (64, 128); got "
                  f"H={H} Kh={Kh} D={D}")
    build.require(block_tables.shape == (B, nb) and kv_len.shape == (B,),
                  NAME, "block_tables (B, nb) and kv_len (B,) expected")
    build.require(block_tables.dtype == torch.int32
                  and kv_len.dtype == torch.int32, NAME,
                  "block_tables and kv_len must be int32")
    build.require(all(t.is_contiguous() for t in args), NAME,
                  "all inputs must be contiguous")
    out = torch.empty_like(q)
    if B == 0:
        return out
    rc = _bind()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                 B, H, Kh, D, P, nb, float(softcap), code,
                 build.stream_ptr(dev))
    build.check(rc, NAME)
    launches += 1
    return out
