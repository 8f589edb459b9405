// Dense-cache GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ragged_decode_attention` (`_kernel` +
// `_flash_decode_block`) of src/repro/kernels/ragged_decode_attention.py:
// one new query token per slot attends over that slot's rows of a dense
// (B, S, Kh, D) cache, rows [0, kv_len) valid.  It serves the engine's
// dense layout (`SlotEngine(paged=False)`).
//
// What bounds it on the H100: bytes, the live rows over 3.35 TB/s.  The
// body is the paged kernel's (decode_attention.cuh) with contiguous rows:
// row t of slot b, KV head kh sits at ((b*S + t)*Kh + kh)*D, and there is
// no block table.  The TPU kernel skipped whole 128-row blocks past
// kv_len and asserted S % 128 == 0; this one walks exactly the rows
// [0, min(kv_len, S)) in 32-row warp chunks, so any S works (the engine's
// max_total_len is 64 in the tests and 2048 on the card) and nothing past
// S or kv_len is read.  kv_len == 0 gives zeros.

#include "decode_attention.cuh"

using namespace rt;

namespace {

template <typename T, int D, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32)
ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, const int* __restrict__ kv_len,
                     T* __restrict__ out, int H, int S, int Kh, float scale,
                     float softcap) {
  constexpr int E = D / 32;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long row_stride = (long long)Kh * D;
  const long long base = (long long)b * S * row_stride + (long long)kh * D
                         + lane * E;
  const DenseRows<T, E> rows{kc + base, vc + base, row_stride};
  decode_attention_cta<T, D, G>(q, rows, out, b, kh, H, min(kv_len[b], S),
                                scale, softcap);
}

template <typename T>
bool dispatch(int D, int G, const void* q, const void* kc, const void* vc,
              const void* kv_len, void* out, int B, int H, int S, int Kh,
              float softcap, cudaStream_t s) {
  const float scale = 1.0f / sqrtf((float)D);
#define RT_LAUNCH(DD, GG)                                                    \
  ragged_decode_kernel<T, DD, GG><<<dim3(Kh, B), kDecodeWarps * 32, 0, s>>>( \
      static_cast<const T*>(q), static_cast<const T*>(kc),                   \
      static_cast<const T*>(vc), static_cast<const int*>(kv_len),            \
      static_cast<T*>(out), H, S, Kh, scale, softcap)
  RT_DECODE_SHAPES(D, G, RT_LAUNCH)
#undef RT_LAUNCH
  return false;
}

}  // namespace

// q (B,H,D), k/v cache (B,S,Kh,D) of dtype `dtype`, contiguous; kv_len
// (B,) int32; out (B,H,D).  Returns the cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a shape the kernel was not
// instantiated for).
extern "C" int ragged_decode_attention(const void* q, const void* kc,
                                       const void* vc, const void* kv_len,
                                       void* out, int B, int H, int S, int Kh,
                                       int D, float softcap, int dtype,
                                       void* stream) {
  const int G = H / Kh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == kF32)
    ok = dispatch<float>(D, G, q, kc, vc, kv_len, out, B, H, S, Kh, softcap, s);
  else if (dtype == kBF16)
    ok = dispatch<__nv_bfloat16>(D, G, q, kc, vc, kv_len, out, B, H, S, Kh, softcap, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
