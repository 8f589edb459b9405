"""Per-CTA timeline of the bf16 fused head kernel on the card.

Builds a copy of ``csrc/fused_sample.cu`` whose kernel stamps
``%globaltimer`` at each CTA's start, when its first stage has landed,
when its last tile's epilogue ends (its ring drained), when it takes its
ticket (its partials written) and, in the last CTA, when the merge of
every CTA's partials ends; then calls it once per head after an L2 flush
(``chip_smoke.flush_l2``) and reports, in microseconds from the first
CTA's start, the medians over 5 calls of: the first stage (median and
last CTA), the loop ends (least, median, 90th percentile, last), the last
ticket and the merge's end.  The gap between the last ticket and the
merge's end is the in-kernel merge; between the last loop end and the
last ticket, the CTA's own merge.

    python3 tools/fused_sample_trace.py    # on the card; ~1 min

Writes ``chiprun_out/fused_sample_trace.json``.
"""
import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

STAMP = ('__device__ unsigned long long g_fs_trace[1024 * 8];\n'
         '__device__ __forceinline__ unsigned long long fs_now() {\n'
         '  unsigned long long t;\n'
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
         '  return t;\n}\n')
# (text of the kernel, the same text with a stamp): fields a CTA are
# start, first stage landed, loop end (max over the warpgroups), ticket,
# merge end (the last CTA only), tiles
EDITS = [
    ("template <int N, bool TIED>\n__global__",
     STAMP + "template <int N, bool TIED>\n__global__"),
    ("  const int P = 128 / N, Q = 2 * P;            // partials a column: Q\n",
     "  const int P = 128 / N, Q = 2 * P;            // partials a column: Q\n"
     "  unsigned long long* tr = g_fs_trace + 8 * blockIdx.x;\n"
     "  if (threadIdx.x == 0) {\n    tr[0] = fs_now();\n"
     "    tr[5] = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;\n  }\n"),
    ("      mbar_wait(full + 8 * s, (it / stages) & 1);\n",
     "      mbar_wait(full + 8 * s, (it / stages) & 1);\n"
     "      if (it == 0 && threadIdx.x == 0) tr[1] = fs_now();\n"),
    ("  // this CTA's partial of each column, one warp a column, into the\n",
     "  if (wt == 0) atomicMax(tr + 2, fs_now());\n"
     "  // this CTA's partial of each column, one warp a column, into the\n"),
    ("  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == G - 1;\n",
     "  if (threadIdx.x == 0) tr[3] = fs_now();\n"
     "  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == G - 1;\n"),
    ("  if (threadIdx.x == 0) *counter = 0;",
     "  named_sync(3, 256);\n"
     "  if (threadIdx.x == 0) tr[4] = fs_now();\n"
     "  if (threadIdx.x == 0) *counter = 0;"),
]
ENTRY = ('\nextern "C" int fs_trace_clear() {\n'
         '  static unsigned long long z[1024 * 8];\n'
         '  return (int)cudaMemcpyToSymbol(g_fs_trace, z, sizeof(z));\n}\n'
         'extern "C" int fs_trace(void* h) {\n'
         '  return (int)cudaMemcpyFromSymbol(h, g_fs_trace,\n'
         '                                   sizeof(g_fs_trace));\n}\n')


def build_traced(build):
    src = (build.CSRC / "fused_sample.cu").read_text()
    for a, b in EDITS:
        if a not in src:
            raise SystemExit(f"trace edit not found: {a[:60]!r}")
        src = src.replace(a, b)
    d = build.BUILD_DIR / "fused_sample_trace"
    d.mkdir(parents=True, exist_ok=True)
    (d / "fused_sample.cu").write_text(src + ENTRY)
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(d / "lib.so"),
                        str(d / "fused_sample.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed\n{r.stderr[-3000:]}")
    return ctypes.CDLL(str(d / "lib.so"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("fused_sample_trace: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels import fused_sample as fsm
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    so = build_traced(build)
    fn = so.fused_sample
    fn.argtypes = fsm._bind().fused_sample.argtypes
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for label, B, Dm, V, tied in cs.FUSED_HEADS:
        w = (torch.randn((V, Dm) if tied else (Dm, V), generator=g,
                         device=dev) / math.sqrt(Dm)).bfloat16()
        w = w.T if tied else w
        x = torch.randn((B, Dm), generator=g, device=dev).bfloat16()
        p = fsm.plan(B, Dm, V, 1, fsm.sm_count(dev))
        ws, counter = fsm.workspace(dev, stream, p.ws_floats)
        outs = [torch.empty((B, 1), device=dev),
                torch.empty((B, 1), dtype=torch.int32, device=dev),
                torch.empty((B, 1), device=dev)]
        runs = []
        for _ in range(5):
            so.fs_trace_clear()
            cs.flush_l2(torch)
            rc = fn(x.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
                    *[t.data_ptr() for t in outs], ws.data_ptr(), ws.numel(),
                    counter.data_ptr(), B, Dm, V, 1, 0.0, 1, p.n, p.stages,
                    p.grid, p.smem, stream)
            torch.cuda.synchronize()
            if rc != 0:
                raise SystemExit(f"{label}: launch failed {rc}")
            h = (ctypes.c_ulonglong * 8192)()
            so.fs_trace(h)
            t = np.frombuffer(h, dtype=np.uint64).reshape(1024, 8)
            t = t[t[:, 0] > 0].astype(np.int64)
            t0 = t[:, 0].min()

            def us(c):
                return (t[:, c] - t0) / 1000.0
            runs.append(dict(
                ctas=len(t), tiles_min=int(t[:, 5].min()),
                tiles_max=int(t[:, 5].max()),
                start_last=float(us(0).max()),
                first_stage=float(np.median(us(1))),
                first_stage_last=float(us(1).max()),
                loop_end_least=float(us(2).min()),
                loop_end_median=float(np.median(us(2))),
                loop_end_p90=float(np.percentile(us(2), 90)),
                loop_end_last=float(us(2).max()),
                ticket_last=float(us(3).max()),
                merge_end=float(us(4).max())))
        row = {"head": label, "B": B, "Dm": Dm, "V": V, "tied": tied,
               "plan": p.__dict__, "l2": "cold",
               **{k: statistics.median(r[k] for r in runs)
                  for k in runs[0]}}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del w, x
        torch.cuda.empty_cache()
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "fused_sample_trace.json").write_text(json.dumps(rows,
                                                               indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
