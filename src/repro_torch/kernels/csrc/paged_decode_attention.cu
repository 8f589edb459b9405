// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_decode_attention` (`_paged_kernel`
// + `_flash_decode_block`) of src/repro/kernels/ragged_decode_attention.py:
// one new query token per slot attends over that slot's KV, which lives in
// a pool of 16-row pages reached through a block table.
//
// What bounds it on the H100: bytes.  Every live K and V row is read once
// (kv_len x Kh x D x 2 tensors x element size per slot) and there are only
// 4 x G flops per element read, far below the ~295 flop/byte the card needs
// before its tensor cores become the limit.  So the design reads each live
// row once, coalesced, and does nothing else to memory:
//   * one CTA per (KV head, slot) holds all G query heads that share the
//     KV head, so a K/V row is read once for G heads;
//   * the CTA's 8 warps each take 32-token chunks (two 16-row pages) and a
//     warp stages a chunk's rows in registers: lane i holds D/32 adjacent
//     elements of each row, so one row is one 256-byte (bf16, D=128)
//     coalesced load; the physical page of each row comes from the block
//     table, which the CTA reads itself;
//   * the online softmax (running max, sum and accumulator, all f32) is
//     kept per warp, as `_flash_decode_block` keeps it per grid step, and
//     the warps are merged in shared memory at the end;
//   * rows at or past kv_len are never read; kv_len == 0 gives zeros.
// Not yet done (later work): split-KV across CTAs for long kv_len with few
// slots, cp.async/TMA prefetch of the next chunk.

#include "common.cuh"

using namespace rt;

namespace {

constexpr int kWarps = 8;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ kv_len, T* __restrict__ out,
                    int H, int Kh, int P, int nb, float scale, float softcap) {
  constexpr int E = D / 32;                  // elements of a row per lane
  const int kh = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int len = min(kv_len[b], nb * P);     // rows the table can reach
  const long long row_stride = (long long)Kh * D;
  const long long page_stride = (long long)P * row_stride;
  const int* table = bt + (long long)b * nb;
  const long long head_off = (long long)kh * D + lane * E;

  float qr[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<T, E>(q + ((long long)b * H + kh * G + g) * D + lane * E, qr[g]);
#pragma unroll
    for (int i = 0; i < E; ++i) qr[g][i] *= scale;
  }
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[g][i] = 0.f;
  }

  for (int c0 = w * 32; c0 < len; c0 += kWarps * 32) {
    const int n = min(32, len - c0);         // >= 1, warp-uniform
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = -CUDART_INF_F;
    // scores: lane j ends up holding the scores of token c0 + j
    for (int j = 0; j < n; ++j) {
      const int t = c0 + j;
      float kf[E];
      load_vec<T, E>(kp + table[t / P] * page_stride + (t % P) * row_stride
                         + head_off, kf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) part = fmaf(qr[g][i], kf[i], part);
        part = warp_sum(part);
        if (lane == j) sc[g] = part;
      }
    }
    const bool valid = lane < n;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = sc[g];
      if (softcap > 0.f && valid) s = tanhf(s / softcap) * softcap;
      if (!valid) s = -CUDART_INF_F;
      const float m_new = fmaxf(m[g], warp_max(s));   // finite
      const float p = valid ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[g] - m_new);         // 0 on the first chunk
      l[g] = l[g] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < E; ++i) acc[g][i] *= alpha;
      m[g] = m_new;
      sc[g] = p;
    }
    for (int j = 0; j < n; ++j) {
      const int t = c0 + j;
      float vf[E];
      load_vec<T, E>(vp + table[t / P] * page_stride + (t % P) * row_stride
                         + head_off, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(0xffffffffu, sc[g], j);
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] = fmaf(pj, vf[i], acc[g][i]);
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[w][g] = m[g];
      sm_l[w][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) sm_acc[w][g][lane * E + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D, d = idx % D;
    float M = -CUDART_INF_F;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) M = fmaxf(M, sm_m[ww][g]);
    float Lsum = 0.f, A = 0.f;
    if (M != -CUDART_INF_F) {
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        const float f = expf(sm_m[ww][g] - M);
        Lsum += f * sm_l[ww][g];
        A += f * sm_acc[ww][g][d];
      }
    }
    out[((long long)b * H + kh * G + g) * D + d] = from_f<T>(A / fmaxf(Lsum, 1e-30f));
  }
}

template <typename T, int D, int G>
void launch(const void* q, const void* kp, const void* vp, const void* bt,
            const void* kv_len, void* out, int B, int H, int Kh, int P, int nb,
            float softcap, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  paged_decode_kernel<T, D, G><<<dim3(Kh, B), kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(kv_len), static_cast<T*>(out), H, Kh, P, nb,
      scale, softcap);
}

template <typename T>
bool dispatch(int D, int G, const void* q, const void* kp, const void* vp,
              const void* bt, const void* kv_len, void* out, int B, int H,
              int Kh, int P, int nb, float softcap, cudaStream_t s) {
#define RT_CASE(DD, GG)                                                     \
  if (D == DD && G == GG) {                                                 \
    launch<T, DD, GG>(q, kp, vp, bt, kv_len, out, B, H, Kh, P, nb, softcap, s); \
    return true;                                                            \
  }
  RT_CASE(64, 1) RT_CASE(64, 2) RT_CASE(64, 4) RT_CASE(64, 8)
  RT_CASE(128, 1) RT_CASE(128, 2) RT_CASE(128, 4) RT_CASE(128, 8)
#undef RT_CASE
  return false;
}

}  // namespace

// q (B,H,D), k/v pages (N,P,Kh,D) of dtype `dtype`, contiguous; block
// tables (B,nb) int32; kv_len (B,) int32; out (B,H,D).  Returns the
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// the kernel was not instantiated for).
extern "C" int paged_decode_attention(const void* q, const void* kp,
                                      const void* vp, const void* bt,
                                      const void* kv_len, void* out, int B,
                                      int H, int Kh, int D, int P, int nb,
                                      float softcap, int dtype, void* stream) {
  const int G = H / Kh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = false;
  if (dtype == kF32)
    ok = dispatch<float>(D, G, q, kp, vp, bt, kv_len, out, B, H, Kh, P, nb, softcap, s);
  else if (dtype == kBF16)
    ok = dispatch<__nv_bfloat16>(D, G, q, kp, vp, bt, kv_len, out, B, H, Kh, P, nb, softcap, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
