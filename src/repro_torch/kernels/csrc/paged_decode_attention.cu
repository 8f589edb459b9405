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
// What bounds it on the H100: bytes.  Two designs, chosen by q's dtype:
//   * bf16 q (every serve path): paged_decode_hopper.cuh, one launch a
//     call: a balanced persistent grid planned on the device from kv_len,
//     a warp a KV head streaming its page rows through a cp.async ring,
//     both products on tensor cores (int8 rows dequantised on the way into
//     a fragment), the merge of an item split across CTAs inside the
//     kernel.  Pages of 16 rows; the wrapper passes a workspace it keeps.
//     Head shapes: D 64/128 with G 1/2/4/8, (64, 3), and (192, 12),
//     (128, 16), (96, 1) on fp or int8 pages, (256, 2) on fp pages only
//     (Gemma2-2B serves on the dense layout);
//   * f32 q (the card's f32 checks, the RL session's tiny LM): the split-KV
//     body of decode_attention.cuh, shared with the dense kernel: a grid of
//     (KV head, slot, split of the block table's rows), a cp.async ring,
//     a merge pass launched behind it from f32 partials when a slot has
//     more than one live split.  D 64/128 with G 1/2/4/8 and (64, 3) on fp
//     or int8 pages, and D 32, G 1 on fp pages.
// int8 pages halve the bytes of bf16 pages and become bf16 or f32 only in
// registers; the page scale multiplies each row's score and weight, so the
// pool never exists in a wider type in device memory.  The int8 kernels
// read each slot's new row (row kv_len - 1) unquantised from k_new/v_new,
// as the reference engine attends before it requantises the written page.
// Rows at or past kv_len are never read; kv_len == 0 gives zeros.

#include "decode_attention.cuh"
#include "paged_decode_hopper.cuh"

using namespace rt;

namespace {

template <typename T, typename KV>
int dispatch(int D, int G, DecodeParams& p, int B, cudaStream_t s) {
#define RT_LAUNCH(DD, GG) (int)launch_decode<T, KV, DD, GG>(p, B, s)
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// bf16 q: the Hopper kernel at every shape it is instantiated for
template <typename KV>
int dispatch_hopper(int D, int G, const PdParams& p, cudaStream_t s) {
#define RT_LAUNCH(DD, GG) (int)launch_pd_hopper<KV, DD, GG>(p, s)
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
  if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    RT_DECODE_WIDE_SHAPES(D, G, RT_LAUNCH)
  } else {
    RT_DECODE_INT8_WIDE_SHAPES(D, G, RT_LAUNCH)
  }
#undef RT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename KV>
int grid_hopper(int D, int G) {
#define RT_LAUNCH(DD, GG) pd_grid<KV, DD, GG>()
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
  if constexpr (std::is_same<KV, __nv_bfloat16>::value) {
    RT_DECODE_WIDE_SHAPES(D, G, RT_LAUNCH)
  } else {
    RT_DECODE_INT8_WIDE_SHAPES(D, G, RT_LAUNCH)
  }
#undef RT_LAUNCH
  return -1;
}

}  // namespace

// Splits of the f32 kernels' grid for a block table of `nb` entries of
// `P`-row pages: the wrapper sizes the partials (B, H, splits, 2) and
// (B, H, splits, D) by it (none are needed when it is 1).
extern "C" int paged_decode_splits(int nb, int P) {
  return decode_splits(nb * P);
}

// Rows of a slot one CTA of the f32 split-KV kernels takes.
extern "C" int paged_decode_split_rows() { return kDecodeSplitRows; }

// Rows of a page the bf16 kernel takes.
extern "C" int paged_decode_page_rows() { return kPdPage; }

// CTAs of the bf16 kernel's grid at (D, G) over `kv_dtype` pages (kBF16
// or kI8) on the current device: SMs x (CTAs an SM holds) x waves.  -1
// where no kernel is instantiated.
extern "C" int paged_decode_ctas(int D, int G, int kv_dtype) {
  if (kv_dtype == kBF16) return grid_hopper<__nv_bfloat16>(D, G);
  if (kv_dtype == kI8) return grid_hopper<int8_t>(D, G);
  return -1;
}

// KV heads a unit of the bf16 kernel takes at (D, G) and Kh.
extern "C" int paged_decode_group(int D, int G, int Kh) {
  return pd_group(Kh, pd_warps(D, G));
}

// f32 of the bf16 kernel's workspace at (D, G, Kh) over `kv_dtype` pages
// on the current device: 2 slots a CTA, each of the unit's KV heads' G
// heads (max, sum, D accumulators); -1 where no kernel is instantiated.
extern "C" long long paged_decode_workspace_floats(int D, int G, int Kh,
                                                   int kv_dtype) {
  const int ctas = paged_decode_ctas(D, G, kv_dtype);
  if (ctas <= 0) return -1;
  return 2LL * ctas * paged_decode_group(D, G, Kh) * G * (2 + D);
}

// q (B,H,D) of `dtype`; k/v pages (N,P,Kh,D) of `kv_dtype` (q's dtype, or
// kI8 with k/v scales (N,) f32 and the new rows k/v_new (B,Kh,D) of
// `dtype`; all four are ignored otherwise), all contiguous; block tables
// (B,nb) int32; kv_len (B,) int32; out (B,H,D).  bf16 q: `ws` f32 of
// paged_decode_workspace_floats(D, G, Kh, kv_dtype) and `counters` int32
// (B, Kh), zero (the launch leaves them
// zero), the pools 16-byte aligned, P 16; one launch.  f32 q: part_ml/part_acc f32
// scratch of paged_decode_splits(nb, P) splits (unused when that is 1);
// the split pass and, with more than one split, the merge pass.  On
// `stream`.  Returns the cudaGetLastError() after the launches
// (cudaErrorInvalidValue for a shape, page size or dtype pair without a
// kernel).
extern "C" int paged_decode_attention(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* kn, const void* vn, const void* bt,
    const void* kv_len, void* out, void* part_ml, void* part_acc, void* ws,
    void* counters, int B, int H, int Kh, int D, int P, int nb,
    float softcap, int dtype, int kv_dtype, void* stream) {
  const int G = H / Kh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (P != kPdPage || ws == nullptr || counters == nullptr ||
        (kv_dtype != kBF16 && kv_dtype != kI8) ||
        reinterpret_cast<uintptr_t>(kp) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(vp) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    PdParams p{};
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const char*>(kp);
    p.v = static_cast<const char*>(vp);
    p.table = static_cast<const int*>(bt);
    p.kv_len = static_cast<const int*>(kv_len);
    p.ks = static_cast<const float*>(ks);
    p.vs = static_cast<const float*>(vs);
    p.k_new = static_cast<const __nv_bfloat16*>(kn);
    p.v_new = static_cast<const __nv_bfloat16*>(vn);
    p.out = static_cast<__nv_bfloat16*>(out);
    p.ws = static_cast<float*>(ws);
    p.counters = static_cast<int*>(counters);
    p.B = B;
    p.H = H;
    p.Kh = Kh;
    p.nb = nb;
    p.scale = 1.0f / sqrtf((float)D);
    p.softcap = softcap;
    if (kv_dtype == kBF16)
      return dispatch_hopper<__nv_bfloat16>(D, G, p, s);
    return dispatch_hopper<int8_t>(D, G, p, s);
  }
  if (dtype != kF32) return (int)cudaErrorInvalidValue;
  const int kv_size = kv_dtype == kF32 ? 4 : 1;
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
  if (kv_dtype == kF32) {
    if (D == 32 && G == 1)                    // the RL session's tiny LM
      return (int)launch_decode<float, float, 32, 1>(p, B, s);
    return dispatch<float, float>(D, G, p, B, s);
  }
  if (kv_dtype == kI8) return dispatch<float, int8_t>(D, G, p, B, s);
  return (int)cudaErrorInvalidValue;
}
