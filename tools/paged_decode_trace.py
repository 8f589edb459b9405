"""Per-CTA timeline of the bf16 paged decode kernel on the card.

Builds a copy of ``csrc/paged_decode_attention.cu`` whose Hopper kernel
stamps ``%globaltimer`` at its start, after its plan, when its first page
is ready, when its ring drains (the last warp's loop end) and when its
last piece is settled (merged or counted), then calls it once per shape
after an L2 flush (``chip_smoke.flush_l2``) and reports, in
microseconds from the first CTA's start, the medians over 5 calls of:
the plan, the first page (median and last CTA), the loop ends (least,
median, 90th percentile, last) and the last settle.  The gap between the
last loop end and the last settle is the merge's tail.

    python3 tools/paged_decode_trace.py    # on the card; ~1 min

Writes ``chiprun_out/paged_decode_trace.json``.
"""
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

STAMP = ('__device__ unsigned long long g_pd_trace[1024 * 8];\n'
         '__device__ __forceinline__ unsigned long long pd_now() {\n'
         '  unsigned long long t;\n'
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
         '  return t;\n}\n')
# (text of the kernel, the same text with a stamp): fields a CTA are
# start, plan, loop end (max over warps), settle end (max), units, first
# page ready (min over warps)
EDITS = [
    ("template <typename KV, int D, int G>\n__global__",
     STAMP + "template <typename KV, int D, int G>\n__global__"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  if (tid == 0) g_pd_trace[8 * blockIdx.x] = pd_now();\n"),
    ("  const long long U = plan[0], ce = plan[1], u0 = plan[2], "
     "n = plan[3] - u0;\n",
     "  const long long U = plan[0], ce = plan[1], u0 = plan[2], "
     "n = plan[3] - u0;\n"
     "  unsigned long long* tr = g_pd_trace + 8 * blockIdx.x;\n"
     "  if (tid == 0) { tr[1] = pd_now(); tr[4] = n; tr[5] = ~0ull; }\n"
     "  __syncthreads();\n"),
    ("    page(s, lim);\n",
     "    if (k == 0 && lane == 0) atomicMin(tr + 5, pd_now());\n"
     "    page(s, lim);\n"),
    ("  cp_async_wait<0>();\n  __syncwarp();\n  if (first_merge) {",
     "  cp_async_wait<0>();\n  __syncwarp();\n"
     "  if (lane == 0) atomicMax(tr + 2, pd_now());\n"
     "  if (first_merge) {"),
    ("    write_out(w);\n    return;\n  }\n  int* c = items",
     "    write_out(w);\n    if (lane == 0) atomicMax(tr + 3, pd_now());\n"
     "    return;\n  }\n  int* c = items"),
    ("    merge(w, -1, nullptr, nullptr);\n  }\n}",
     "    merge(w, -1, nullptr, nullptr);\n  }\n"
     "  if (lane == 0) atomicMax(tr + 3, pd_now());\n}"),
]
ENTRY = ('\nextern "C" int pd_trace_clear() {\n'
         '  static unsigned long long z[1024 * 8];\n'
         '  return (int)cudaMemcpyToSymbol(rt::g_pd_trace, z, sizeof(z));\n}\n'
         'extern "C" int pd_trace(void* h) {\n'
         '  return (int)cudaMemcpyFromSymbol(h, rt::g_pd_trace,\n'
         '                                   sizeof(rt::g_pd_trace));\n}\n')


def build_traced(build):
    hop = (build.CSRC / "paged_decode_hopper.cuh").read_text()
    for a, b in EDITS:
        if a not in hop:
            raise SystemExit(f"trace edit not found: {a[:60]!r}")
        hop = hop.replace(a, b)
    d = build.BUILD_DIR / "paged_decode_trace"
    d.mkdir(parents=True, exist_ok=True)
    (d / "paged_decode_hopper.cuh").write_text(hop)
    (d / "paged_decode_attention.cu").write_text(
        (build.CSRC / "paged_decode_attention.cu").read_text() + ENTRY)
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(d / "lib.so"),
                        str(d / "paged_decode_attention.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed\n{r.stderr[-3000:]}")
    return ctypes.CDLL(str(d / "lib.so"))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("paged_decode_trace: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    so = build_traced(build)
    fn = so.paged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    so.paged_decode_workspace_floats.argtypes = [ctypes.c_int] * 4
    so.paged_decode_workspace_floats.restype = ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for label, lens, H, Kh, D in cs.paged_variant_shapes()[:5]:
        q, kp, vp, bt, kv = cs.paged_inputs(torch, dev, torch.bfloat16,
                                            lens, H, Kh, D)
        _, k8, v8, ks8, vs8, _, _ = cs.int8_inputs(ref, (q, kp, vp, bt, kv))
        kn, vn = (torch.randn((len(lens), Kh, D), generator=g,
                              device=dev).bfloat16() for _ in range(2))
        for kind, a, code in (("fp", (q, kp, vp, None, None, None, None),
                               1),
                              ("int8", (q, k8, v8, ks8, vs8, kn, vn), 2)):
            B, G, nb = q.shape[0], H // Kh, bt.shape[1]
            ws = torch.empty(so.paged_decode_workspace_floats(D, G, Kh, code),
                             device=dev)
            cnt = torch.zeros(B * Kh, dtype=torch.int32, device=dev)
            out = torch.empty_like(q)
            args = [*a, bt, kv, out, None, None, ws, cnt]
            runs = []
            for _ in range(5):
                so.pd_trace_clear()
                cs.flush_l2(torch)
                rc = fn(*[build.data_ptr(t) for t in args], B, H, Kh, D, 16,
                        nb, 0.0, 1, code, stream)
                torch.cuda.synchronize()
                if rc != 0:
                    raise SystemExit(f"{label}/{kind}: launch failed {rc}")
                h = (ctypes.c_ulonglong * 8192)()
                so.pd_trace(h)
                t = np.frombuffer(h, dtype=np.uint64).reshape(1024, 8)
                t = t[t[:, 0] > 0].astype(np.int64)
                t0 = t[:, 0].min()

                def us(c):
                    return (t[:, c] - t0) / 1000.0
                runs.append(dict(
                    ctas=len(t), units_min=int(t[:, 4].min()),
                    units_max=int(t[:, 4].max()),
                    plan=float(np.median(us(1))),
                    first_page=float(np.median(us(5))),
                    first_page_last=float(us(5).max()),
                    loop_end_least=float(us(2).min()),
                    loop_end_median=float(np.median(us(2))),
                    loop_end_p90=float(np.percentile(us(2), 90)),
                    loop_end_last=float(us(2).max()),
                    settle_last=float(us(3).max())))
            row = {"shape": label, "kind": kind, "l2": "cold",
                   **{k: statistics.median(r[k] for r in runs)
                      for k in runs[0]}}
            print(json.dumps(row), flush=True)
            rows.append(row)
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "paged_decode_trace.json").write_text(json.dumps(rows,
                                                               indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
