// Dense-cache GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ragged_decode_attention` (`_kernel` +
// `_flash_decode_block`) of src/repro/kernels/ragged_decode_attention.py:
// one new query token per slot attends over that slot's rows of a dense
// (B, S, Kh, D) cache, rows [kv_start, kv_len) valid (kv_start 0 unless
// given: a left-padded slot's rows start past its pads).  It serves the
// engine's dense layout (`SlotEngine(paged=False)`).
//
// What bounds it on the H100: bytes, the live rows over 3.35 TB/s.  Two
// designs, chosen by q's dtype:
//   * bf16 q (every serve path): dense_decode_hopper.cuh, one launch a
//     call: a balanced persistent grid planned on the device from kv_len
//     and kv_start, a warp a KV head streaming chunks of its contiguous
//     rows into its own ring (TMA, cp.async at D 96), an online softmax over
//     K and V in
//     flight together, both products on tensor cores, the merge of a slot
//     split across CTAs inside the kernel, each CTA holding a piece of it
//     merging a slice of its columns (a cooperative launch).  The wrapper
//     passes a workspace it keeps.  Head shapes:
//     D 64/128 with G 1/2/4/8, (64, 3), and (192, 12), (256, 2), (128, 16),
//     (96, 1);
//   * f32 q (the card's f32 checks): the split-KV body of
//     decode_attention.cuh (a grid of (KV head, slot, split of S's rows), a
//     merge pass from f32 partials), D 64/128 with G 1/2/4/8 and (64, 3).
// The TPU kernel skipped whole 128-row blocks past kv_len and asserted
// S % 128 == 0; both designs read exactly the rows [kv_start, min(kv_len,
// S)), so any S works (the engine's max_total_len is 64 in the tests and
// 2048 on the card; Gemma2-2B's rings are 4096 rows and its global caches
// 8192; the launch path's are 33,280 and 524,800) and nothing past S or
// kv_len is read.  No live row (kv_len == 0, or kv_start >= kv_len) gives
// zeros.  It serves both of Gemma2's caches: a local layer passes its ring
// with min(kv_len + 1, W) rows (the ring holds exactly the window, so no
// window is applied), a global layer its cache with kv_len + 1.  It also
// serves Whisper-small's decode step (D 64, G 1): the decoder's own cache
// with kv_len + 1 rows, and the cross K/V of the encoder's 1500 rows with
// every row live; Phi-3-Vision-4.2B's dense layout (bf16 D 96, G 1); and
// Zamba2-1.2B's shared attention block (bf16 D 64, G 1), whose slots
// start at kv_start, past their left pads.

#include "decode_attention.cuh"
#include "dense_decode_hopper.cuh"

using namespace rt;

namespace {

// f32 q: the split-KV body, rows from kv_start
template <typename T>
int dispatch(int D, int G, DecodeParams& p, int B, cudaStream_t s) {
#define RT_LAUNCH(DD, GG) (int)launch_decode<T, T, DD, GG, true>(p, B, s)
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// bf16 q: the Hopper kernel at every shape it is instantiated for
int dispatch_hopper(int D, int G, const DdParams& p, cudaStream_t s) {
#define RT_LAUNCH(DD, GG) (int)launch_dd_hopper<DD, GG>(p, s)
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
  RT_DECODE_WIDE_SHAPES(D, G, RT_LAUNCH)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

int grid_hopper(int D, int G) {
#define RT_LAUNCH(DD, GG) dd_grid<DD, GG>()
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
  RT_DECODE_WIDE_SHAPES(D, G, RT_LAUNCH)
#undef RT_LAUNCH
  return -1;
}

int rows_hopper(int D, int G) {
#define RT_LAUNCH(DD, GG) DdShape<DD, GG>::kRows
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
  RT_DECODE_WIDE_SHAPES(D, G, RT_LAUNCH)
#undef RT_LAUNCH
  return -1;
}

}  // namespace

// Splits of the f32 grid for an S-row cache (see paged_decode_splits).
extern "C" int ragged_decode_splits(int S) { return decode_splits(S); }

// CTAs of the bf16 kernel's grid at (D, G) on the current device: SMs x
// (CTAs an SM holds); -1 where no kernel is instantiated.
extern "C" int ragged_decode_ctas(int D, int G) { return grid_hopper(D, G); }

// Rows of a unit of the bf16 kernel at (D, G); -1 where none.
extern "C" int ragged_decode_rows(int D, int G) { return rows_hopper(D, G); }

// KV heads a unit of the bf16 kernel takes at (D, G) and Kh.
extern "C" int ragged_decode_group(int D, int G, int Kh) {
  return pd_group(Kh, dd_warps(D, G));
}

// f32 of the bf16 kernel's workspace at (D, G, Kh) on the current device:
// 2 slots a CTA, each of the unit's KV heads' G heads (max, sum, D
// accumulators); -1 where no kernel is instantiated.
extern "C" long long ragged_decode_workspace_floats(int D, int G, int Kh) {
  const int ctas = ragged_decode_ctas(D, G);
  if (ctas <= 0) return -1;
  return 2LL * ctas * ragged_decode_group(D, G, Kh) * G * (2 + D);
}

// q (B,H,D), k/v cache (B,S,Kh,D) of dtype `dtype`, contiguous; kv_len
// (B,) int32; kv_start (B,) int32 or null (rows from 0); out (B,H,D);
// lse (B,H) f32 or null: each head's log-sum-exp of its scaled (and
// capped) scores over the live rows, -inf where a slot has none (what a
// caller needs to combine outputs over blocks of rows).
// bf16: `ws` f32 of ragged_decode_workspace_floats(D, G, Kh) and
// `counters` int32 (2, B, Kh), zero (the launch leaves them zero), the
// caches 16-byte aligned; one cooperative launch.  f32: part_ml/part_acc
// f32 scratch of ragged_decode_splits(S) splits (unused when that is 1);
// the split pass and, with more than one split, the merge pass.  On
// `stream`.  Returns
// the cudaGetLastError() after the launches (cudaErrorInvalidValue for a
// shape the kernel was not instantiated for).
extern "C" int ragged_decode_attention(
    const void* q, const void* kc, const void* vc, const void* kv_len,
    const void* kv_start, void* out, void* lse, void* part_ml,
    void* part_acc, void* ws, void* counters, int B, int H, int S, int Kh,
    int D, float softcap, int dtype, void* stream) {
  const int G = H / Kh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (ws == nullptr || counters == nullptr ||
        reinterpret_cast<uintptr_t>(kc) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(vc) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    DdParams p{};
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const char*>(kc);
    p.v = static_cast<const char*>(vc);
    p.kv_len = static_cast<const int*>(kv_len);
    p.kv_start = static_cast<const int*>(kv_start);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.lse = static_cast<float*>(lse);
    p.ws = static_cast<float*>(ws);
    p.counters = static_cast<int*>(counters);
    p.B = B;
    p.H = H;
    p.S = S;
    p.Kh = Kh;
    p.scale = 1.0f / sqrtf((float)D);
    p.softcap = softcap;
    return dispatch_hopper(D, G, p, s);
  }
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  DecodeParams p{};
  p.q = q;
  p.k = static_cast<const char*>(kc);
  p.v = static_cast<const char*>(vc);
  p.row_stride = (long long)Kh * D * 4;
  p.S = S;
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_start = static_cast<const int*>(kv_start);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.part_ml = static_cast<float*>(part_ml);
  p.part_acc = static_cast<float*>(part_acc);
  p.H = H;
  p.Kh = Kh;
  p.splits = decode_splits(S);
  p.cap = S;
  p.scale = 1.0f / sqrtf((float)D);
  p.softcap = softcap;
  return dispatch<float>(D, G, p, B, s);
}
