"""Per-CTA timeline of the bf16 dense decode kernel on the card.

Builds a copy of ``csrc/ragged_decode_attention.cu`` whose Hopper kernel
(``dense_decode_hopper.cuh``) stamps ``%globaltimer`` at its start,
after its plan, when its first unit is ready, when its last warp's loop
ends and when the CTA is done (its share of its split items' merges
written), then calls it once per shape of
``chip_smoke.DENSE_VARIANT_SHAPES`` after an L2 flush
(``chip_smoke.flush_l2``) and reports, in microseconds from the first
CTA's start, the medians over 5 calls of: the plan, the first unit
(median and last CTA), the loop ends (least, median, 90th percentile,
last), the last CTA's arrive counts, the last end of a wait for an item's
pieces and the last CTA's end.  The gap between the last loop end and
the last end is the merge's tail; the spread of the loop ends is the
unequal service the SMs' equal shares get.

    python3 tools/dense_decode_trace.py    # on the card; ~1 min

Writes ``chiprun_out/dense_decode_trace.json``.
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

STAMP = ('__device__ unsigned long long g_dd_trace[1024 * 16];\n'
         '__device__ __forceinline__ unsigned long long dd_now() {\n'
         '  unsigned long long t;\n'
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));\n'
         '  return t;\n}\n')
# (text of the kernel, the same text with a stamp): fields a CTA are
# start, plan, loop end (max over warps), end, units, first unit ready
# (min over warps), its arrives counted, its last wait for an item's
# pieces ended (items of kDdSpreadPieces or more), the items it merged
# whole (as the CTA completing their count), its first such merge's start
# and its last one's end
EDITS = [
    ("template <int D, int G>\n__global__",
     STAMP + "template <int D, int G>\n__global__"),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  if (tid == 0) g_dd_trace[16 * blockIdx.x] = dd_now();\n"),
    ("  const long long U = plan[0], ce = plan[1], u0 = plan[2], "
     "n = plan[3] - u0;\n",
     "  const long long U = plan[0], ce = plan[1], u0 = plan[2], "
     "n = plan[3] - u0;\n"
     "  unsigned long long* tr = g_dd_trace + 16 * blockIdx.x;\n"
     "  if (tid == 0) { tr[1] = dd_now(); tr[4] = n; tr[5] = ~0ull; }\n"
     "  __syncthreads();\n"),
    ("      unit(s, lim);\n",
     "      if (k == 0 && lane == 0) atomicMin(tr + 5, dd_now());\n"
     "      unit(s, lim);\n"),
    ("    cp_async_wait<0>();\n    finish(w);\n  }\n",
     "    cp_async_wait<0>();\n    finish(w);\n"
     "    if (lane == 0) atomicMax(tr + 2, dd_now());\n  }\n"),
    ("  __syncthreads();\n  for (int i = 0; i < np; ++i) {\n",
     "  __syncthreads();\n  if (tid == 0) tr[6] = dd_now();\n"
     "  for (int i = 0; i < np; ++i) {\n"),
    ("      if (it.last) {\n        __threadfence();\n"
     "        merge(it, 0, KG * kC4, 1);\n      }\n",
     "      if (it.last) {\n        __threadfence();\n"
     "        if (tid == 0 && tr[8]++ == 0) tr[9] = dd_now();\n"
     "        merge(it, 0, KG * kC4, 1);\n"
     "        __syncthreads();\n"
     "        if (tid == 0) tr[10] = dd_now();\n      }\n"),
    ("    __syncthreads();\n    __threadfence();\n    const int own",
     "    __syncthreads();\n    __threadfence();\n"
     "    if (tid == 0) tr[7] = dd_now();\n    const int own"),
    ("      depart[c] = 0;\n    }\n  }\n}",
     "      depart[c] = 0;\n    }\n  }\n"
     "  __syncthreads();\n  if (tid == 0) tr[3] = dd_now();\n}"),
]
ENTRY = ('\nextern "C" int dd_trace_clear() {\n'
         '  static unsigned long long z[1024 * 16];\n'
         '  return (int)cudaMemcpyToSymbol(rt::g_dd_trace, z, sizeof(z));\n}\n'
         'extern "C" int dd_trace(void* h) {\n'
         '  return (int)cudaMemcpyFromSymbol(h, rt::g_dd_trace,\n'
         '                                   sizeof(rt::g_dd_trace));\n}\n')


def build_traced(build):
    src = (build.CSRC / "dense_decode_hopper.cuh").read_text()
    for a, b in EDITS:
        if a not in src:
            raise SystemExit(f"trace edit not found: {a[:60]!r}")
        src = src.replace(a, b)
    d = build.BUILD_DIR / "dense_decode_trace"
    d.mkdir(parents=True, exist_ok=True)
    (d / "dense_decode_hopper.cuh").write_text(src)
    (d / "ragged_decode_attention.cu").write_text(
        (build.CSRC / "ragged_decode_attention.cu").read_text() + ENTRY)
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(d / "lib.so"),
                        str(d / "ragged_decode_attention.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise SystemExit(f"nvcc failed\n{r.stderr[-3000:]}")
    return ctypes.CDLL(str(d / "lib.so"))


def merges(t, t0):
    """The whole-item merges: the most a CTA made, their span (first
    start to last end) at the median and the longest of the CTAs making
    any, and at the CTA that ended last: its merges, their start and end
    (us from the first CTA's start)."""
    import numpy as np
    m = t[t[:, 8] > 0]
    last = t[np.argmax(t[:, 3])]
    span = (m[:, 10] - m[:, 9]) / 1000.0 if len(m) else np.zeros(1)
    return dict(
        merges_most=int(t[:, 8].max()),
        merge_span_median=float(np.median(span)),
        merge_span_longest=float(span.max()),
        last_cta_merges=int(last[8]),
        last_cta_merge_start=(float((last[9] - t0) / 1000.0)
                              if last[8] else None),
        last_cta_merge_end=(float((last[10] - t0) / 1000.0)
                            if last[8] else None))


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("dense_decode_trace: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    so = build_traced(build)
    fn = so.ragged_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    so.ragged_decode_workspace_floats.argtypes = [ctypes.c_int] * 3
    so.ragged_decode_workspace_floats.restype = ctypes.c_longlong
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, S, key, H, Kh, D, cap in cs.DENSE_VARIANT_SHAPES:
        lens, starts = cs.dense_variant_lens(key)
        q, kc, vc, kv = cs.dense_inputs(torch, dev, torch.bfloat16, lens, S,
                                        H, Kh, D)
        st = (None if starts is None else
              torch.tensor(starts, dtype=torch.int32, device=dev))
        B, G = q.shape[0], H // Kh
        ws = torch.empty(so.ragged_decode_workspace_floats(D, G, Kh),
                         device=dev)
        cnt = torch.zeros(2 * B * Kh, dtype=torch.int32, device=dev)
        out = torch.empty_like(q)
        args = [q, kc, vc, kv, st, out, None, None, None, ws, cnt]
        runs = []
        for _ in range(5):
            so.dd_trace_clear()
            cs.flush_l2(torch)
            rc = fn(*[build.data_ptr(t) for t in args], B, H, S, Kh, D, cap,
                    1, stream)
            torch.cuda.synchronize()
            if rc != 0:
                raise SystemExit(f"{label}: launch failed {rc}")
            h = (ctypes.c_ulonglong * 16384)()
            so.dd_trace(h)
            t = np.frombuffer(h, dtype=np.uint64).reshape(1024, 16)
            t = t[t[:, 0] > 0].astype(np.int64)
            t0 = t[:, 0].min()
            busy = t[t[:, 4] > 0]

            def us(c, rows=busy):
                return (rows[:, c] - t0) / 1000.0
            runs.append(dict(
                ctas=len(t), units_min=int(busy[:, 4].min()),
                units_max=int(busy[:, 4].max()),
                start_last=float(((t[:, 0] - t0) / 1000.0).max()),
                plan=float(np.median(us(1))),
                first_unit=float(np.median(us(5))),
                first_unit_last=float(us(5).max()),
                loop_end_least=float(us(2).min()),
                loop_end_median=float(np.median(us(2))),
                loop_end_p90=float(np.percentile(us(2), 90)),
                loop_end_last=float(us(2).max()),
                arrived_last=float(((t[:, 6] - t0) / 1000.0).max()),
                wait_end_last=(float(((t[t[:, 7] > 0, 7] - t0)
                                      / 1000.0).max())
                               if (t[:, 7] > 0).any() else None),
                end_last=float(((t[:, 3] - t0) / 1000.0).max()),
                **merges(t, t0)))
        row = {"shape": label, "l2": "cold",
               "card": cs.card_name_and_power(),
               **{k: (statistics.median(v) if v else None)
                  for k in runs[0]
                  for v in [[r[k] for r in runs if r[k] is not None]]}}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del q, kc, vc, kv, st, ws, out
        torch.cuda.empty_cache()
    cs.OUT.mkdir(exist_ok=True)
    (cs.OUT / "dense_decode_trace.json").write_text(json.dumps(rows,
                                                               indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
