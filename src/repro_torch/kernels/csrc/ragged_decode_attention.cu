// Dense-cache GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ragged_decode_attention` (`_kernel` +
// `_flash_decode_block`) of src/repro/kernels/ragged_decode_attention.py:
// one new query token per slot attends over that slot's rows of a dense
// (B, S, Kh, D) cache, rows [kv_start, kv_len) valid (kv_start 0 unless
// given: a left-padded slot's rows start past its pads).  It serves the
// engine's dense layout (`SlotEngine(paged=False)`).
//
// What bounds it on the H100: bytes, the live rows over 3.35 TB/s.  The
// body is the paged kernel's (decode_attention.cuh: split-KV over equal
// row ranges, a cp.async ring, a merge pass) with contiguous rows: row t
// of slot b sits at global row b*S + t, and there is no block table.  The
// TPU kernel skipped whole 128-row blocks past kv_len and asserted
// S % 128 == 0; this one reads exactly the rows [kv_start, min(kv_len, S)), so
// any S works (the engine's max_total_len is 64 in the tests and 2048 on
// the card; Gemma2-2B's rings are 4096 rows and its global caches 8192)
// and nothing past S or kv_len is read.  kv_len == 0 gives zeros.  It
// serves both of Gemma2's caches: a local layer passes its ring with
// min(kv_len + 1, W) rows (the ring holds exactly the window, so no
// window is applied), a global layer its cache with kv_len + 1.  It also
// serves Whisper-small's decode step (D 64, G 1): the decoder's own cache
// with kv_len + 1 rows, and the cross K/V of the encoder's 1500 rows with
// every row live; Phi-3-Vision-4.2B's dense layout (bf16 D 96, G 1); and
// Zamba2-1.2B's shared attention block (bf16 D 64, G 1), whose slots
// start at kv_start, past their left pads.

#include "decode_attention.cuh"

using namespace rt;

namespace {

template <typename T>
int dispatch(int D, int G, DecodeParams& p, int B, cudaStream_t s) {
#define RT_LAUNCH(DD, GG) (int)launch_decode<T, T, DD, GG, true>(p, B, s)
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    RT_DECODE_WIDE_SHAPES(D, G, RT_LAUNCH)
  }
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Splits of the grid for an S-row cache (see paged_decode_splits).
extern "C" int ragged_decode_splits(int S) { return decode_splits(S); }

// q (B,H,D), k/v cache (B,S,Kh,D) of dtype `dtype`, contiguous; kv_len
// (B,) int32; kv_start (B,) int32 or null (rows from 0); out (B,H,D); part_ml/part_acc f32 scratch of
// ragged_decode_splits(S) splits (unused when that is 1).  Returns the
// cudaGetLastError() after the launches (cudaErrorInvalidValue for a
// shape the kernel was not instantiated for).
extern "C" int ragged_decode_attention(const void* q, const void* kc,
                                       const void* vc, const void* kv_len,
                                       const void* kv_start, void* out, void* part_ml,
                                       void* part_acc, int B, int H, int S,
                                       int Kh, int D, float softcap,
                                       int dtype, void* stream) {
  DecodeParams p{};
  p.q = q;
  p.k = static_cast<const char*>(kc);
  p.v = static_cast<const char*>(vc);
  p.row_stride = (long long)Kh * D * (dtype == kF32 ? 4 : 2);
  p.S = S;
  p.kv_len = static_cast<const int*>(kv_len);
  p.kv_start = static_cast<const int*>(kv_start);
  p.out = out;
  p.part_ml = static_cast<float*>(part_ml);
  p.part_acc = static_cast<float*>(part_acc);
  p.H = H;
  p.Kh = Kh;
  p.splits = decode_splits(S);
  p.cap = S;
  p.scale = 1.0f / sqrtf((float)D);
  p.softcap = softcap;
  const int G = H / Kh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch<float>(D, G, p, B, s);
  if (dtype == kBF16) return dispatch<__nv_bfloat16>(D, G, p, B, s);
  return (int)cudaErrorInvalidValue;
}
