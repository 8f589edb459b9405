// Paged GQA decode attention for Hopper (sm_90a), over fp or int8 pages.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` of
// src/repro/kernels/ragged_decode_attention.py in both its variants:
// `_paged_kernel` (fp pages) and `_paged_kernel_int8` (int8 pages, one f32
// scale per physical page, scalar-prefetched there and looked up through
// the block table here).  One new query token per slot attends over that
// slot's KV, which lives in a pool of P-row pages reached through a block
// table.
//
// What bounds it on the H100: bytes (see decode_attention.cuh, which holds
// the body and its design: split-KV over equal row ranges, a cp.async page
// ring, scores summed by 4 lanes a row, a merge pass).  Each CTA reads its
// split's block-table entries, and for int8 pages the pages' scales, once
// into shared memory; its ring then fetches the rows of those pages.
// int8 pages halve the bytes of bf16 pages: they travel through the same
// ring as 128-byte rows (D = 128), become f32 in registers, and the page
// scale multiplies each row's score and weight, so the pool never exists
// in f32 in device memory.  q and the output stay f32 or bf16.  The int8
// instantiation reads each slot's new row (row kv_len - 1) unquantised
// from k_new/v_new, as the reference engine attends before it requantises
// the written page.  Rows at or past kv_len are never read, kv_len == 0
// gives zeros.  Head shapes: D 64/128 with G 1/2/4/8 and Granite-MoE's
// D 64, G 3 in f32 and bf16 (fp or int8 pages), and with bf16 q
// Nemotron-4-340B's D 192, G 12, Qwen3-MoE-235B-A22B's D 128, G 16 and
// Phi-3-Vision-4.2B's D 96, G 1 (fp or int8 pages; an int8 D 96 row is
// 6 chunks, padded to 8 in shared memory, see decode_attention.cuh) and
// Gemma2-2B's D 256, G 2 (fp pages only: Gemma2 serves on the dense
// layout).

#include "decode_attention.cuh"

using namespace rt;

namespace {

template <typename T, typename KV>
int dispatch(int D, int G, DecodeParams& p, int B, cudaStream_t s) {
#define RT_LAUNCH(DD, GG) (int)launch_decode<T, KV, DD, GG>(p, B, s)
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if constexpr (std::is_same<KV, T>::value) {
      RT_DECODE_WIDE_SHAPES(D, G, RT_LAUNCH)
    } else {                                  // int8 pages
      RT_DECODE_INT8_WIDE_SHAPES(D, G, RT_LAUNCH)
    }
  }
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Splits of the grid for a block table of `nb` entries of `P`-row pages:
// the wrapper sizes the partials (B, H, splits, 2) and (B, H, splits, D)
// by it (none are needed when it is 1).
extern "C" int paged_decode_splits(int nb, int P) {
  return decode_splits(nb * P);
}

// Rows of a slot one CTA takes (the decode kernels' split).
extern "C" int paged_decode_split_rows() { return kDecodeSplitRows; }

// q (B,H,D) of `dtype`; k/v pages (N,P,Kh,D) of `kv_dtype` (q's dtype, or
// kI8 with k/v scales (N,) f32 and the new rows k/v_new (B,Kh,D) of
// `dtype`; all four are ignored otherwise), all contiguous; block tables
// (B,nb) int32; kv_len (B,) int32; out (B,H,D); part_ml/part_acc f32
// scratch of paged_decode_splits(nb, P) splits (unused when that is 1).
// Launches the split pass and, with more than one split, the merge pass
// on `stream`.  Returns the cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape or dtype pair the kernel was not
// instantiated for).
extern "C" int paged_decode_attention(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* kn,
                                      const void* vn, const void* bt,
                                      const void* kv_len, void* out,
                                      void* part_ml, void* part_acc, int B,
                                      int H, int Kh, int D, int P, int nb,
                                      float softcap, int dtype, int kv_dtype,
                                      void* stream) {
  const int G = H / Kh;
  const int kv_size = kv_dtype == kF32 ? 4 : kv_dtype == kBF16 ? 2 : 1;
  DecodeParams p{};
  p.q = q;
  p.k = static_cast<const char*>(kp);
  p.v = static_cast<const char*>(vp);
  p.row_stride = (long long)Kh * D * kv_size;
  p.table = static_cast<const int*>(bt);
  p.nb = nb;
  p.P = P;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.k_new = kn;
  p.v_new = vn;
  p.kv_len = static_cast<const int*>(kv_len);
  p.out = out;
  p.part_ml = static_cast<float*>(part_ml);
  p.part_acc = static_cast<float*>(part_acc);
  p.H = H;
  p.Kh = Kh;
  p.splits = decode_splits(nb * P);
  p.cap = nb * P;                             // rows the table can reach
  p.scale = 1.0f / sqrtf((float)D);
  p.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32 && kv_dtype == kF32) {
    if (D == 32 && G == 1)                    // the RL session's tiny LM
      return (int)launch_decode<float, float, 32, 1>(p, B, s);
    return dispatch<float, float>(D, G, p, B, s);
  }
  if (dtype == kBF16 && kv_dtype == kBF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(D, G, p, B, s);
  if (dtype == kF32 && kv_dtype == kI8)
    return dispatch<float, int8_t>(D, G, p, B, s);
  if (dtype == kBF16 && kv_dtype == kI8)
    return dispatch<__nv_bfloat16, int8_t>(D, G, p, B, s);
  return (int)cudaErrorInvalidValue;
}
