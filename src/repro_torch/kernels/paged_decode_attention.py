"""Paged GQA decode attention: wrapper of ``csrc/paged_decode_attention.cu``.

Replaces the Pallas TPU kernel ``paged_decode_attention`` in
``repro/kernels/ragged_decode_attention.py``, both variants: fp pages
(``_paged_kernel``) and int8 pages with one f32 scale per physical page
(``_paged_kernel_int8``, the reference's ``ops.paged_decode_attention_int8``).
Bound on the H100: bytes, the live K/V rows (and, for int8, their pages'
scales) over 3.35 TB/s.

bf16 q (every serve path) runs ``csrc/paged_decode_hopper.cuh``, one
launch a call: a persistent grid of SMs x (CTAs an SM holds) splits the
(slot, KV head group, page) units evenly, planned on the device from
``kv_len`` (the host never reads it), a warp a KV head streams its page
rows through a ``cp.async`` ring, both products run on tensor cores (int8
rows dequantised on the way into a fragment), and an item split across
CTAs is merged inside the kernel through a workspace.  This module keeps
that workspace per device and stream (f32 partials and the items'
counters, zeroed once, grown when a call needs more, never allocated per
call).  f32 q runs the split-KV body of ``csrc/decode_attention.cuh`` (a
grid per split of the block table's rows and a merge pass from f32
partials).

CPU tensors take the plain versions (``ref.paged_decode_attention_ref``,
``ref.paged_decode_attention_int8_ref``); CUDA tensors launch the kernel
or raise.  fp and int8 launches are counted under their own names.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (paged_decode_attention_int8_ref,
                                     paged_decode_attention_ref)

NAME = "paged_decode_attention"
NAME_INT8 = "paged_decode_attention_int8"
launches = {NAME: 0, NAME_INT8: 0}   # kernel launches since the last reset
PAGE_ROWS = 16      # bf16 q: the Hopper kernel's page size (the engine's)
_lib = None
_grids = {}         # (device, D, G, kv code) -> CTAs of the bf16 grid
_ws_floats = {}     # (device, D, G, Kh, kv code) -> f32 of its workspace
_workspaces = {}    # (device, stream) -> (f32 partials, int32 counters)


def _bind():
    global _lib
    if _lib is None:
        lib = build.load(NAME)
        lib.paged_decode_attention.argtypes = (
            [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.paged_decode_attention.restype = ctypes.c_int
        lib.paged_decode_ctas.argtypes = [ctypes.c_int] * 3
        lib.paged_decode_ctas.restype = ctypes.c_int
        lib.paged_decode_group.argtypes = [ctypes.c_int] * 3
        lib.paged_decode_group.restype = ctypes.c_int
        lib.paged_decode_workspace_floats.argtypes = [ctypes.c_int] * 4
        lib.paged_decode_workspace_floats.restype = ctypes.c_longlong
        lib.paged_decode_splits.argtypes = [ctypes.c_int] * 2
        lib.paged_decode_splits.restype = ctypes.c_int
        lib.paged_decode_split_rows.argtypes = []
        lib.paged_decode_split_rows.restype = ctypes.c_int
        _lib = lib
    return _lib


def split_rows() -> int:
    """Rows of a slot one CTA of the f32 split-KV decode kernels takes
    (builds the library; the card's edge cases are placed around it)."""
    return _bind().paged_decode_split_rows()


def hopper_ctas(D: int, G: int, int8: bool = False) -> int:
    """CTAs of the bf16 kernel's grid at (D, G) over fp (or int8) pages on
    the current device: SMs x (CTAs an SM holds).  The card's plan edges
    are placed with it (``ref.paged_decode_work_plan``)."""
    dev = torch.cuda.current_device()
    kv = build.KV_INT8 if int8 else build.DTYPE_CODES[torch.bfloat16]
    key = (dev, D, G, kv)
    if key not in _grids:
        n = _bind().paged_decode_ctas(D, G, kv)
        build.require(n > 0, NAME, f"no bf16 kernel at D={D} G={G}"
                      + (" on int8 pages" if int8 else ""))
        _grids[key] = n
    return _grids[key]


def hopper_group(D: int, G: int, Kh: int) -> int:
    """KV heads one unit of the bf16 kernel takes (one warp each)."""
    return _bind().paged_decode_group(D, G, Kh)


def workspace_floats(D: int, G: int, Kh: int, int8: bool = False) -> int:
    """f32 of the bf16 kernel's workspace at (D, G, Kh) on the current
    device (the C side owns its layout)."""
    kv = build.KV_INT8 if int8 else build.DTYPE_CODES[torch.bfloat16]
    key = (torch.cuda.current_device(), D, G, Kh, kv)
    if key not in _ws_floats:
        n = _bind().paged_decode_workspace_floats(D, G, Kh, kv)
        build.require(n > 0, NAME, f"no bf16 kernel at D={D} G={G}"
                      + (" on int8 pages" if int8 else ""))
        _ws_floats[key] = n
    return _ws_floats[key]


def workspace(dev: torch.device, floats: int, items: int):
    """The bf16 kernel's workspace on ``dev``'s current stream: f32
    partials of at least ``floats`` and int32 counters of at least
    ``items``, zero between launches (each launch leaves them zero).
    Kept across calls, grown (a new zeroed buffer) when a call needs
    more."""
    key = (dev.index, build.stream_ptr(dev))
    ws, counters = _workspaces.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(floats, dtype=torch.float32, device=dev)
    if counters is None or counters.numel() < items:
        counters = torch.zeros(items, dtype=torch.int32, device=dev)
    _workspaces[key] = (ws, counters)
    return ws, counters


def paged_decode_attention(q, k_pages, v_pages, block_tables, kv_len,
                           softcap: float = 0.0, window: int = 0,
                           k_scales=None, v_scales=None, k_new=None,
                           v_new=None) -> torch.Tensor:
    """q (B, H, D); k/v_pages (N, P, Kh, D); block_tables (B, nb) int32;
    kv_len (B,) int32 -> (B, H, D).  Rows at or past ``kv_len`` are
    masked; ``kv_len == 0`` gives zeros.

    int8 pages come with ``k_scales``/``v_scales`` (N,) f32, one per
    physical page, and ``k_new``/``v_new`` (B, Kh, D) in q's dtype: each
    slot's new row, read unquantised in place of row ``kv_len - 1`` (the
    caller requantises the written page after the step, as the reference
    engine does).  On the CPU the new rows may be left out (the pool is
    then read as it is); on CUDA an int8 call needs them, and an fp call
    takes none.  q and the output stay f32/bf16.  ``window`` is applied
    by the plain versions only: the kernel takes none, so a window on
    CUDA raises instead of being ignored."""
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError(f"{NAME}: pass both k_scales and v_scales or neither")
    new = k_new is not None
    if new != (v_new is not None):
        raise ValueError(f"{NAME}: pass both k_new and v_new or neither")
    if new and not quant:
        raise ValueError(f"{NAME}: new rows (k_new/v_new) are for int8 "
                         "pages only")
    name = NAME_INT8 if quant else NAME
    args = (q, k_pages, v_pages, block_tables, kv_len)
    if build.takes_plain(*args, k_scales, v_scales, k_new, v_new):
        if quant:
            return paged_decode_attention_int8_ref(
                q, k_pages, v_pages, k_scales, v_scales, block_tables,
                kv_len, softcap=softcap, window=window, k_new=k_new,
                v_new=v_new)
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          kv_len, softcap=softcap,
                                          window=window)
    if window:
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no sliding window (got {window})")
    dev = build.require_cuda(name, *args, k_scales, v_scales, k_new, v_new)
    code = build.dtype_code(name, q)
    kv_code = build.kv_dtype_code(name, q, k_pages, v_pages)
    build.require((kv_code == build.KV_INT8) == quant, name,
                  "int8 pages need k_scales and v_scales; fp pages take none")
    build.require(new == quant, name,
                  "int8 pages on CUDA need the new rows k_new and v_new")
    B, H, D = q.shape
    N, P, Kh, Dk = k_pages.shape
    nb = block_tables.shape[1]
    build.require(v_pages.shape == k_pages.shape and Dk == D, name,
                  f"page shapes {tuple(k_pages.shape)}/{tuple(v_pages.shape)}"
                  f" do not match q {tuple(q.shape)}")
    tiny = (D == 32 and H == Kh and q.dtype == torch.float32
            and kv_code != build.KV_INT8)
    fits = build.decode_shape_ok(D, H // Kh, q.dtype,
                                 int8=kv_code == build.KV_INT8)
    build.require(H % Kh == 0 and (fits or tiny),
                  name, f"needs G in (1, 2, 4, 8), D in (64, 128), or (D, G) "
                  f"(64, 3) (or G 1, D 32 on f32 pages; or with bf16 q "
                  f"(D, G) in (192, 12), (128, 16), (96, 1), and (256, 2) on "
                  f"fp pages only); got H={H} Kh={Kh} D={D} {q.dtype}"
                  + (" on int8 pages" if kv_code == build.KV_INT8 else ""))
    build.require(block_tables.shape == (B, nb) and kv_len.shape == (B,),
                  name, "block_tables (B, nb) and kv_len (B,) expected")
    build.require(block_tables.dtype == torch.int32
                  and kv_len.dtype == torch.int32, name,
                  "block_tables and kv_len must be int32")
    scales = (k_scales, v_scales) if quant else ()
    build.require(all(s.shape == (N,) and s.dtype == torch.float32
                      for s in scales), name,
                  f"k/v_scales must be ({N},) float32")
    rows = (k_new, v_new) if quant else ()
    build.require(all(r.shape == (B, Kh, D) and r.dtype == q.dtype
                      for r in rows), name,
                  f"k/v_new must be ({B}, {Kh}, {D}) of q's dtype")
    build.require(all(t.is_contiguous() for t in args + scales + rows), name,
                  "all inputs must be contiguous")
    bf16 = q.dtype == torch.bfloat16
    build.require(not bf16 or P == PAGE_ROWS, name,
                  f"bf16 q needs pages of {PAGE_ROWS} rows, got {P}")
    build.require(not bf16 or (k_pages.data_ptr() % 16 == 0
                               and v_pages.data_ptr() % 16 == 0), name,
                  "page pools must start on a 16-byte boundary (bulk copies)")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _bind()
    part_ml = part_acc = ws = counters = None
    if bf16:
        ws, counters = workspace(
            dev, workspace_floats(D, H // Kh, Kh, int8=quant), B * Kh)
    else:
        part_ml, part_acc = build.split_scratch(
            lib.paged_decode_splits(nb, P), B, H, D, dev)
    rc = lib.paged_decode_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scales.data_ptr() if quant else None,
        v_scales.data_ptr() if quant else None,
        k_new.data_ptr() if quant else None,
        v_new.data_ptr() if quant else None,
        block_tables.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        build.data_ptr(part_ml), build.data_ptr(part_acc),
        build.data_ptr(ws), build.data_ptr(counters),
        B, H, Kh, D, P, nb, float(softcap), code, kv_code,
        build.stream_ptr(dev))
    build.check(rc, name)
    launches[name] += 1
    return out


def paged_decode_attention_int8(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, kv_len, softcap: float = 0.0,
                                window: int = 0, k_new=None,
                                v_new=None) -> torch.Tensor:
    """The reference's ``ops.paged_decode_attention_int8`` signature:
    int8 pages with per-page f32 scales (and the new rows, see above)."""
    return paged_decode_attention(q, k_pages, v_pages, block_tables, kv_len,
                                  softcap=softcap, window=window,
                                  k_scales=k_scales, v_scales=v_scales,
                                  k_new=k_new, v_new=v_new)
