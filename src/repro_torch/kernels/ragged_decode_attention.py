"""Dense GQA decode attention: wrapper of ``csrc/ragged_decode_attention.cu``.

Replaces the Pallas TPU kernel ``ragged_decode_attention`` (``_kernel`` +
``_flash_decode_block``) in ``repro/kernels/ragged_decode_attention.py``:
one query token per slot over a dense ``(B, S, Kh, D)`` cache, rows at or
past ``kv_len`` skipped, and with ``kv_start`` the rows before it too.
It serves the engine's dense layout (``SlotEngine(paged=False)``),
Gemma2-2B's ring and global caches included, Whisper-small's decode (its
self-attention cache and its cross-attention over the encoder's 1500
rows, every row live), Zamba2-1.2B's shared attention, whose
left-padded slots start at ``kv_start``, and the launch path's decode_32k
and long_500k caches.  Bound on the H100: bytes, the live K/V rows over
3.35 TB/s.  Unlike the TPU kernel it takes any S, not only multiples of
128.

bf16 q (every serve path) runs ``csrc/dense_decode_hopper.cuh``, one
launch a call: a persistent grid of SMs x (CTAs an SM holds) splits the
(slot, KV head group, chunk of rows) units evenly, planned on the device
from ``kv_len`` and ``kv_start`` (the host never reads them), a warp a KV
head streams its rows into a ring of its own (TMA boxes at D a multiple
of 64, ``cp.async`` at D 96), both products run on tensor cores, and a
slot split across CTAs is merged inside the kernel through a workspace
(by the CTA that completes it, or at long rows by every CTA holding a
piece: a cooperative launch).  That workspace (f32 partials and the
items' arrive and depart counters, zeroed once, grown when a call needs
more, never allocated per call) is the paged decode's, kept per device
and stream (``paged_decode_attention.workspace``): the two kernels take
turns on a stream and each leaves the counters at zero.  f32 q runs the
split-KV body of ``csrc/decode_attention.cuh`` (a grid per split of S's
rows and a merge pass from f32 partials).

With ``return_lse`` the call also writes each head's log-sum-exp (B, H)
f32 of its scores over the live rows (-inf where a slot has none), in
all three ways a call ends (one piece, the completing CTA's merge, every
CTA's slice of a long row's merge; in f32 the split body and its merge
pass): what a rank needs to combine its block of a cache's rows with the
other ranks' (``distributed.sharding.combine_decode``).

CPU tensors take the plain version (``ref.ragged_decode_attention_ref``);
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode_attention import workspace
from repro_torch.kernels.ref import ragged_decode_attention_ref

NAME = "ragged_decode_attention"
launches = {NAME: 0}    # kernel launches since the last reset
_lib = None
_grids = {}         # (device, D, G) -> CTAs of the bf16 grid
_ws_floats = {}     # (device, D, G, Kh) -> f32 of its workspace


def _bind():
    global _lib
    if _lib is None:
        lib = build.load(NAME)
        lib.ragged_decode_attention.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.ragged_decode_attention.restype = ctypes.c_int
        lib.ragged_decode_splits.argtypes = [ctypes.c_int]
        lib.ragged_decode_splits.restype = ctypes.c_int
        lib.ragged_decode_ctas.argtypes = [ctypes.c_int] * 2
        lib.ragged_decode_ctas.restype = ctypes.c_int
        lib.ragged_decode_rows.argtypes = [ctypes.c_int] * 2
        lib.ragged_decode_rows.restype = ctypes.c_int
        lib.ragged_decode_group.argtypes = [ctypes.c_int] * 3
        lib.ragged_decode_group.restype = ctypes.c_int
        lib.ragged_decode_workspace_floats.argtypes = [ctypes.c_int] * 3
        lib.ragged_decode_workspace_floats.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def hopper_ctas(D: int, G: int) -> int:
    """CTAs of the bf16 kernel's grid at (D, G) on the current device: SMs
    x (CTAs an SM holds).  The card's plan edges are placed with it
    (``ref.ragged_decode_work_plan``)."""
    key = (torch.cuda.current_device(), D, G)
    if key not in _grids:
        n = _bind().ragged_decode_ctas(D, G)
        build.require(n > 0, NAME, f"no bf16 kernel at D={D} G={G}")
        _grids[key] = n
    return _grids[key]


def hopper_rows(D: int, G: int) -> int:
    """Rows of a unit (a chunk of a slot's live rows) of the bf16 kernel."""
    return _bind().ragged_decode_rows(D, G)


def hopper_group(D: int, G: int, Kh: int) -> int:
    """KV heads one unit of the bf16 kernel takes (one warp each)."""
    return _bind().ragged_decode_group(D, G, Kh)


def workspace_floats(D: int, G: int, Kh: int) -> int:
    """f32 of the bf16 kernel's workspace at (D, G, Kh) on the current
    device (the C side owns its layout)."""
    key = (torch.cuda.current_device(), D, G, Kh)
    if key not in _ws_floats:
        n = _bind().ragged_decode_workspace_floats(D, G, Kh)
        build.require(n > 0, NAME, f"no bf16 kernel at D={D} G={G}")
        _ws_floats[key] = n
    return _ws_floats[key]


def ragged_decode_attention(q, k_cache, v_cache, kv_len,
                            softcap: float = 0.0, window: int = 0,
                            kv_start=None, return_lse: bool = False):
    """q (B, H, D); k/v_cache (B, S, Kh, D); kv_len (B,) int32 ->
    (B, H, D), and with ``return_lse`` also the heads' log-sum-exp (B, H)
    f32.  Rows at or past ``kv_len`` are masked (all S rows when
    ``kv_len > S``), and with ``kv_start`` (B,) int32 the rows before it
    (a left-padded slot's pads); no live row (``kv_len == 0``, or
    ``kv_start >= kv_len``) gives zeros and an lse of -inf.  ``window``
    is applied by the plain version only: the kernel takes none, so a
    window on CUDA raises instead of being ignored."""
    args = (q, k_cache, v_cache, kv_len, kv_start)
    if build.takes_plain(*args):
        return ragged_decode_attention_ref(q, k_cache, v_cache, kv_len,
                                           softcap=softcap, window=window,
                                           kv_start=kv_start,
                                           return_lse=return_lse)
    if window:
        raise NotImplementedError(
            f"{NAME}: the CUDA kernel has no sliding window (got {window})")
    dev = build.require_cuda(NAME, *args)
    code = build.dtype_code(NAME, q, k_cache, v_cache)
    B, H, D = q.shape
    Bk, S, Kh, Dk = k_cache.shape
    build.require(v_cache.shape == k_cache.shape and Bk == B and Dk == D,
                  NAME, f"cache shapes {tuple(k_cache.shape)}/"
                  f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    build.require(H % Kh == 0 and build.decode_shape_ok(D, H // Kh, q.dtype),
                  NAME, f"needs G in (1, 2, 4, 8) and D in (64, 128), or "
                  f"(D, G) (64, 3), or in bf16 (D, G) in (192, 12), (256, 2),"
                  f" (128, 16), (96, 1); got H={H} Kh={Kh} D={D} {q.dtype}")
    for name, t in (("kv_len", kv_len), ("kv_start", kv_start)):
        build.require(t is None or (t.shape == (B,)
                                    and t.dtype == torch.int32), NAME,
                      f"{name} must be (B,) int32")
    build.require(all(t.is_contiguous() for t in args
                      if t is not None), NAME,
                  "all inputs must be contiguous")
    bf16 = q.dtype == torch.bfloat16
    build.require(not bf16 or (k_cache.data_ptr() % 16 == 0
                               and v_cache.data_ptr() % 16 == 0), NAME,
                  "caches must start on a 16-byte boundary (bulk copies)")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    if B == 0:
        return (out, lse) if return_lse else out
    lib = _bind()
    part_ml = part_acc = ws = counters = None
    if bf16:
        ws, counters = workspace(dev, workspace_floats(D, H // Kh, Kh),
                                 2 * B * Kh)
    else:
        part_ml, part_acc = build.split_scratch(lib.ragged_decode_splits(S),
                                                B, H, D, dev)
    rc = lib.ragged_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), build.data_ptr(kv_start), out.data_ptr(),
        build.data_ptr(lse), build.data_ptr(part_ml),
        build.data_ptr(part_acc),
        build.data_ptr(ws), build.data_ptr(counters), B, H, S, Kh, D,
        float(softcap), code, build.stream_ptr(dev))
    build.check(rc, NAME)
    launches[NAME] += 1
    return (out, lse) if return_lse else out
