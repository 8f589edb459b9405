"""Fused LM head + top-k + logsumexp: wrapper of ``csrc/fused_sample.cu``.

Replaces the Pallas TPU kernel ``fused_sample`` (``_fused_sample_kernel``)
in ``repro/kernels/ragged_decode_attention.py``.  Bound on the H100:
bytes, the head W (Dm x V) read once per decode step (311 MB for
Qwen3-0.6B in bf16, ~93 us at 3.35 TB/s).  The bf16 kernel reads W once
for every batch up to 64 rows, in one launch: W is ``wgmma``'s A operand
(64 vocabulary rows a warpgroup), x its B operand (N = the rows padded to
8); one persistent CTA per SM walks 128-row vocabulary tiles whose 64-d
stages arrive by TMA into a ring, each beside x's 64-column slice (read
again from L2, not from device memory); each thread carries a running
logsumexp and top-k of one batch column across its tiles, and the last CTA
to finish merges every CTA's partials.  The plan of a call (``plan``)
is computed here and checked by the C entry.  f32 (test shapes) keeps FMAs
and one partial per 128-wide chunk, merged by a second launch.  W is read
through its strides, so a tied head passes ``embed.T`` and is never
transposed in memory.  See the source.

CPU tensors take the plain version (``ref.fused_sample_ref``); CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import fused_sample_ref

NAME = "fused_sample"
launches = {NAME: 0}    # kernel launches since the last reset
_lib = None
_workspaces = {}        # (device index, stream) -> (f32 workspace, counter)
_sms = {}               # device index -> SMs

MAX_K = 16              # top-k entries the kernels keep (csrc KMAX)
VOCAB_TILE = 128        # vocabulary rows a tile of the bf16 kernel (kVT)
D_STAGE = 64            # d a ring stage (kDT)
MAX_ROWS = 64           # x rows a pass (kMaxN)
MAX_STAGES = 8          # ring stages the kernel takes (kMaxStages)
SMEM_MAX = 232448       # shared memory a block can have on the H100
EPI_STRIDE = 68         # floats a column of a logit tile (kEpiStride)
H100_SMS = 132
F32_CHUNK = 128         # vocab chunk of the f32 kernel (VC)


@dataclass(frozen=True)
class Plan:
    """One bf16 call: ``passes`` launches over ``rows`` x rows each
    (padded to ``n``, wgmma's N), each reading W once through a ring of
    ``stages``; ``grid`` CTAs of ``smem`` bytes of shared memory;
    ``ws_floats`` f32 of workspace (a record of one partial per CTA for
    each row)."""
    rows: int
    n: int
    passes: int
    stages: int
    grid: int
    smem: int
    ws_floats: int


def head_smem_bytes(n: int, top_k: int, stages: int) -> int:
    """Shared memory of the bf16 kernel (csrc ``HeadSmem``): 1 KB to
    align, the ring (a stage: 16 KB of W and x's slice of n rows x 64 d),
    two logit tiles, the threads' top-k lists and (max, sum), the
    barriers and a flag."""
    parts = 2 * (128 // n)
    stage = VOCAB_TILE * D_STAGE * 2 + n * D_STAGE * 2
    lists = 8 * n * parts * top_k
    books = 8 * n * parts
    return (1024 + stages * stage + 2 * 4 * n * EPI_STRIDE + lists + books
            + 8 * 2 * stages + 16)


@functools.lru_cache(maxsize=256)
def plan(B: int, Dm: int, V: int, top_k: int = 1,
         sms: int = H100_SMS) -> Plan:
    """The bf16 kernel's plan at these shapes on a card of ``sms`` SMs:
    as many ring stages as fit, up to ``MAX_STAGES``.  Every pass takes
    the first pass's N (a last pass of fewer rows reads zeros past
    them).  ``Dm`` sets no part of it: each stage holds 64 d of W and x
    whatever Dm is.  Cached: the engine asks at every decode step."""
    rows = max(1, min(B, MAX_ROWS))
    n = -(-rows // 8) * 8
    grid = min(sms, -(-V // VOCAB_TILE))
    stages = max((s for s in range(2, MAX_STAGES + 1)
                  if head_smem_bytes(n, top_k, s) <= SMEM_MAX), default=0)
    return Plan(rows=rows, n=n, passes=-(-B // MAX_ROWS), stages=stages,
                grid=grid, smem=head_smem_bytes(n, top_k, stages),
                ws_floats=rows * record_floats(grid, top_k))


def record_floats(grid: int, top_k: int) -> int:
    """f32 of one row's record in the bf16 kernel's workspace (csrc
    ``head_record_floats``): a partial (max, sum, top_k values, top_k
    indices) from each CTA, padded to 16 bytes."""
    return -(-grid * (2 + 2 * top_k) // 4) * 4


def f32_workspace_floats(B: int, V: int, top_k: int) -> int:
    """f32 of the f32 kernel's partials: one per (row, 128-wide chunk)."""
    return B * -(-V // F32_CHUNK) * (2 + 2 * top_k)


def _bind():
    global _lib
    if _lib is None:
        lib = build.load(NAME)
        fn = lib.fused_sample
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2
                       + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] + [ctypes.c_int] * 4
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.fused_sample_max_k.argtypes = []
        lib.fused_sample_max_k.restype = ctypes.c_int
        _lib = lib
    return _lib


def sm_count(dev: torch.device) -> int:
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sms[dev.index]


def workspace(dev: torch.device, stream: int, floats: int):
    """The kernels' workspace on ``dev``'s ``stream`` (a handle, as
    ``build.stream_ptr`` gives it): f32 partials of at least ``floats``
    and an int32 counter that is 0 between launches (each bf16 launch
    leaves it 0).  Kept across calls, grown (a new buffer) when a call
    needs more."""
    key = (dev.index, stream)
    ws, counter = _workspaces.get(key, (None, None))
    if ws is None or ws.numel() < floats:
        ws = torch.empty(max(floats, 1), dtype=torch.float32, device=dev)
    if counter is None:
        counter = torch.zeros(1, dtype=torch.int32, device=dev)
    _workspaces[key] = (ws, counter)
    return ws, counter


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
    build.require(x.dim() == 2, NAME, f"x must be (B, Dm), got {tuple(x.shape)}")
    B, Dm = x.shape
    build.require(w.dim() == 2 and w.shape[0] == Dm, NAME,
                  f"w {tuple(w.shape)} does not match x {tuple(x.shape)}")
    V = w.shape[1]
    build.require(x.is_contiguous(), NAME, "x must be contiguous")
    build.require(min(w.stride()) >= 1, NAME, "w strides must be positive")
    build.require(1 <= top_k <= min(V, MAX_K), NAME,
                  f"top_k must be in [1, {MAX_K}] and <= V, got {top_k}")
    bf16 = code == build.DTYPE_CODES[torch.bfloat16]
    if bf16:
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
    lib = _bind()
    stream = build.stream_ptr(dev)
    if not bf16:
        ws, counter = workspace(dev, stream, f32_workspace_floats(B, V,
                                                                  top_k))
        rc = lib.fused_sample(
            x.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
            vals.data_ptr(), idx.data_ptr(), lse.data_ptr(), ws.data_ptr(),
            ws.numel(), counter.data_ptr(), B, Dm, V, top_k, float(softcap),
            code, 0, 0, 0, 0, stream)
        build.check(rc, NAME)
        launches[NAME] += 1
        return vals, idx, lse
    p = plan(B, Dm, V, top_k, sm_count(dev))
    ws, counter = workspace(dev, stream, p.ws_floats)
    ptrs = (x.data_ptr(), vals.data_ptr(), idx.data_ptr(), lse.data_ptr())
    for r0 in range(0, B, MAX_ROWS):       # one pass unless B > 64
        rc = lib.fused_sample(
            ptrs[0] + 2 * r0 * Dm, w.data_ptr(), w.stride(0), w.stride(1),
            ptrs[1] + 4 * r0 * top_k, ptrs[2] + 4 * r0 * top_k,
            ptrs[3] + 4 * r0, ws.data_ptr(), ws.numel(), counter.data_ptr(),
            min(MAX_ROWS, B - r0), Dm, V, top_k, float(softcap), code, p.n,
            p.stages, p.grid, p.smem, stream)
        build.check(rc, NAME)
        launches[NAME] += 1
    return vals, idx, lse
