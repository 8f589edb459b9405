// Paged GQA decode attention for Hopper (sm_90a), over fp or int8 pages.
//
// Replaces the Pallas TPU kernel `paged_decode_attention` of
// src/repro/kernels/ragged_decode_attention.py in both its variants:
// `_paged_kernel` (fp pages) and `_paged_kernel_int8` (int8 pages, one f32
// scale per physical page, scalar-prefetched there and looked up through
// the block table here).  One new query token per slot attends over that
// slot's KV, which lives in a pool of 16-row pages reached through a block
// table.
//
// What bounds it on the H100: bytes (see decode_attention.cuh, which holds
// the body and its design).  int8 pages halve the bytes of bf16 pages: a
// lane loads D/32 bytes of a row (4 at D = 128) and multiplies them by the
// row's page scale in registers, so the pool never exists in f32 in device
// memory.  q and the output stay f32 or bf16.  The int8 instantiation
// reads each slot's new row (row kv_len - 1) unquantised from k_new/v_new,
// as the reference engine attends before it requantises the written page.
// The CTA reads the block table itself; rows at or past kv_len are never
// read, kv_len == 0 gives zeros.

#include <type_traits>

#include "decode_attention.cuh"

using namespace rt;

namespace {

template <typename T, typename KV, int D, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ kp,
                    const KV* __restrict__ vp, const float* __restrict__ ks,
                    const float* __restrict__ vs, const T* __restrict__ kn,
                    const T* __restrict__ vn, const int* __restrict__ bt,
                    const int* __restrict__ kv_len, T* __restrict__ out,
                    int H, int Kh, int P, int nb, float scale, float softcap) {
  constexpr int E = D / 32;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long row_stride = (long long)Kh * D;
  const long long head_off = (long long)kh * D + lane * E;
  const PagedRows<KV, E> rows{kp + head_off, vp + head_off,
                              bt + (long long)b * nb, P, P * row_stride,
                              row_stride};
  const int len = min(kv_len[b], nb * P);     // rows the table can reach
  if constexpr (std::is_same<KV, int8_t>::value) {
    const long long new_off = ((long long)b * Kh + kh) * D + lane * E;
    decode_attention_cta<T, D, G>(
        q, PagedInt8Rows<T, E>{rows, ks, vs, kn + new_off, vn + new_off,
                               len - 1},
        out, b, kh, H, len, scale, softcap);
  } else {
    decode_attention_cta<T, D, G>(q, rows, out, b, kh, H, len, scale,
                                  softcap);
  }
}

template <typename T, typename KV>
bool dispatch(int D, int G, const void* q, const void* kp, const void* vp,
              const void* ks, const void* vs, const void* kn,
              const void* vn, const void* bt,
              const void* kv_len, void* out, int B, int H, int Kh, int P,
              int nb, float softcap, cudaStream_t s) {
  const float scale = 1.0f / sqrtf((float)D);
#define RT_LAUNCH(DD, GG)                                                    \
  paged_decode_kernel<T, KV, DD, GG><<<dim3(Kh, B), kDecodeWarps * 32, 0, s>>>( \
      static_cast<const T*>(q), static_cast<const KV*>(kp),                  \
      static_cast<const KV*>(vp), static_cast<const float*>(ks),             \
      static_cast<const float*>(vs), static_cast<const T*>(kn),              \
      static_cast<const T*>(vn), static_cast<const int*>(bt),                \
      static_cast<const int*>(kv_len), static_cast<T*>(out), H, Kh, P, nb,   \
      scale, softcap)
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
#undef RT_LAUNCH
  return false;
}

}  // namespace

// q (B,H,D) of `dtype`; k/v pages (N,P,Kh,D) of `kv_dtype` (q's dtype, or
// kI8 with k/v scales (N,) f32 and the new rows k/v_new (B,Kh,D) of
// `dtype`; all four are ignored otherwise), all contiguous; block tables
// (B,nb) int32; kv_len (B,) int32; out (B,H,D).
// Returns the cudaGetLastError() after the launch (cudaErrorInvalidValue
// for a shape or dtype pair the kernel was not instantiated for).
extern "C" int paged_decode_attention(const void* q, const void* kp,
                                      const void* vp, const void* ks,
                                      const void* vs, const void* kn,
                                      const void* vn, const void* bt,
                                      const void* kv_len, void* out, int B,
                                      int H, int Kh, int D, int P, int nb,
                                      float softcap, int dtype, int kv_dtype,
                                      void* stream) {
  const int G = H / Kh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == kF32 && kv_dtype == kF32)
    ok = dispatch<float, float>(D, G, q, kp, vp, ks, vs, kn, vn, bt, kv_len, out, B, H, Kh, P, nb, softcap, s);
  else if (dtype == kBF16 && kv_dtype == kBF16)
    ok = dispatch<__nv_bfloat16, __nv_bfloat16>(D, G, q, kp, vp, ks, vs, kn, vn, bt, kv_len, out, B, H, Kh, P, nb, softcap, s);
  else if (dtype == kF32 && kv_dtype == kI8)
    ok = dispatch<float, int8_t>(D, G, q, kp, vp, ks, vs, kn, vn, bt, kv_len, out, B, H, Kh, P, nb, softcap, s);
  else if (dtype == kBF16 && kv_dtype == kI8)
    ok = dispatch<__nv_bfloat16, int8_t>(D, G, q, kp, vp, ks, vs, kn, vn, bt, kv_len, out, B, H, Kh, P, nb, softcap, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
