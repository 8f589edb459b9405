"""Build the CUDA kernels on first use and bind them through ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/kernels/`` at the root of the checkout.  The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  ``build_all``
starts one ``nvcc`` per source, all at once, and waits for them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_decode_attention", "ragged_decode_attention",
           "flash_attention", "fused_sample")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or add it to PATH)")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str):
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = open(out.with_suffix(".log"), "w")
    proc = subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every stale library in parallel; returns name -> path."""
    jobs = {n: _start(n) for n in names}
    failed = []
    for name, job in jobs.items():
        if job is None:
            continue
        proc, tmp, out, log = job
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {n: lib_path(n) for n in jobs}


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built if stale."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _libs[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """nvcc's ``-Xptxas -v`` output of the last build of ``name``."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaGetLastError()``."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


# -- shared by the wrappers ---------------------------------------------------

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KV_INT8 = 2             # code of int8 KV storage (q and out stay f32/bf16)


def takes_plain(*tensors) -> bool:
    """A wrapper takes its plain version when every tensor is on the CPU,
    or every tensor is on the meta device (no data: the launch path's fit
    report runs a step there for shapes and operation counts)."""
    kinds = {t.device.type for t in tensors if t is not None}
    return kinds in ({"cpu"}, {"meta"})


def require(cond: bool, name: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {what}")


def require_cuda(name: str, *tensors) -> torch.device:
    """All tensors on one CUDA device (a CUDA wrapper never falls back)."""
    devs = {t.device for t in tensors if t is not None}
    require(len(devs) == 1 and next(iter(devs)).type == "cuda", name,
            f"expects tensors on one CUDA device, got {sorted(map(str, devs))}")
    return next(iter(devs))


def dtype_code(name: str, *tensors) -> int:
    dts = {t.dtype for t in tensors}
    require(len(dts) == 1 and next(iter(dts)) in DTYPE_CODES, name,
            f"expects one dtype of float32/bfloat16, got {dts}")
    return DTYPE_CODES[next(iter(dts))]


def kv_dtype_code(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> int:
    """Code of the KV storage, which is q's own dtype or int8 pages."""
    require(k.dtype == v.dtype and k.dtype in (q.dtype, torch.int8), name,
            f"K/V storage must be q's dtype ({q.dtype}) or int8, got "
            f"{k.dtype}/{v.dtype}")
    return KV_INT8 if k.dtype == torch.int8 else dtype_code(name, q)


def split_scratch(splits: int, B: int, H: int, D: int,
                  device: torch.device):
    """f32 partials of a split-KV decode launch: (max, sum) as
    (B, H, splits, 2) and the unnormalised accumulator as
    (B, H, splits, D); None for both when there is one split (the kernel
    then writes its output directly)."""
    if splits <= 1:
        return None, None
    return (torch.empty((B, H, splits, 2), dtype=torch.float32,
                        device=device),
            torch.empty((B, H, splits, D), dtype=torch.float32,
                        device=device))


# (head dim, query heads per KV head) of the decode kernels: every pair of
# these in f32 and bf16 (and (64, 3), Granite-MoE-3B-A800M), and the wide
# heads in bf16 (Nemotron-4-340B, Gemma2-2B, Qwen3-MoE-235B-A22B,
# Phi-3-Vision-4.2B); int8 pages take every wide head but Gemma2-2B's,
# which serves on the dense layout only
DECODE_SHAPES = {(d, g) for d in (64, 128) for g in (1, 2, 4, 8)} | {(64, 3)}
DECODE_WIDE_SHAPES = {(192, 12), (256, 2), (128, 16), (96, 1)}
DECODE_INT8_WIDE_SHAPES = {(192, 12), (128, 16), (96, 1)}


def decode_shape_ok(D: int, G: int, dtype: torch.dtype,
                    int8: bool = False) -> bool:
    """Whether a decode kernel is instantiated at (D, G) for q of
    ``dtype``, over fp K/V or (``int8``) int8 pages."""
    wide = DECODE_INT8_WIDE_SHAPES if int8 else DECODE_WIDE_SHAPES
    return (D, G) in DECODE_SHAPES or (
        dtype == torch.bfloat16 and (D, G) in wide)


def data_ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
