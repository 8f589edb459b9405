// One-token GQA decode attention, the body shared by the paged kernel
// (paged_decode_attention.cu, fp and int8 pages) and the dense kernel
// (ragged_decode_attention.cu), as `_flash_decode_block` is shared by the
// three Pallas variants in src/repro/kernels/ragged_decode_attention.py.
//
// What bounds it on the H100: bytes.  Every live K and V row is read once
// (kv_len x Kh x D x 2 tensors x element size per slot) and there are only
// 4 x G flops per element read, far below the ~295 flop/byte the card needs
// before its tensor cores become the limit.  So the design reads each live
// row once, coalesced, and does nothing else to memory:
//   * one CTA per (KV head, slot) holds all G query heads that share the
//     KV head, so a K/V row is read once for G heads;
//   * the CTA's 8 warps each take 32-token chunks and a warp stages a
//     chunk's rows in registers: lane i holds D/32 adjacent elements of
//     each row, so one row is one coalesced load (256 bytes in bf16 at
//     D = 128, 128 bytes in int8); where a row lives and how its elements
//     become f32 is the `Rows` policy below (dense rows, pages through a
//     block table, int8 pages times their page's f32 scale);
//   * the online softmax (running max, sum and accumulator, all f32) is
//     kept per warp, as `_flash_decode_block` keeps it per grid step, and
//     the warps are merged in shared memory at the end;
//   * rows at or past `len` are never read; len <= 0 gives zeros.
// Not yet done (later work): split-KV across CTAs for long kv_len with few
// slots, cp.async/TMA prefetch of the next chunk.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kDecodeWarps = 8;

// Row sources.  `k`/`v` already point at the CTA's KV head plus the lane's
// first element; load_k/load_v fill the lane's E elements of row t as f32.

// Dense (B, S, Kh, D) cache: row t of the CTA's slot is t rows further on.
template <typename KV, int E>
struct DenseRows {
  const KV* k;
  const KV* v;
  long long row_stride;                      // Kh * D
  __device__ __forceinline__ void load_k(int t, float (&x)[E]) const {
    load_vec<KV, E>(k + t * row_stride, x);
  }
  __device__ __forceinline__ void load_v(int t, float (&x)[E]) const {
    load_vec<KV, E>(v + t * row_stride, x);
  }
};

// (N, P, Kh, D) page pool: row t sits in physical page table[t / P].
template <typename KV, int E>
struct PagedRows {
  const KV* k;
  const KV* v;
  const int* table;                          // the slot's block table row
  int P;
  long long page_stride, row_stride;         // P * Kh * D, Kh * D
  __device__ __forceinline__ int page(int t) const { return table[t / P]; }
  __device__ __forceinline__ long long off(int t) const {
    return page(t) * page_stride + (t % P) * row_stride;
  }
  __device__ __forceinline__ void load_k(int t, float (&x)[E]) const {
    load_vec<KV, E>(k + off(t), x);
  }
  __device__ __forceinline__ void load_v(int t, float (&x)[E]) const {
    load_vec<KV, E>(v + off(t), x);
  }
};

// int8 pages with one f32 scale per physical page (this layer's (N,) row
// of the engine's (L, N) scale plane): float(q) * scale, in registers, as
// the Pallas body dequantises `k_ref.astype(f32) * k_scale`.  Row `last`
// (the slot's new token) is read unquantised from `k_new`/`v_new`, in q's
// dtype: the reference engine attends over the row it has just set in its
// dequantised view and requantises the written page only after the step,
// so the caller requantises after this kernel.
template <typename T, int E>
struct PagedInt8Rows {
  PagedRows<int8_t, E> rows;
  const float* ks;
  const float* vs;
  const T* k_new;                            // the slot's new row, this head
  const T* v_new;                            // plus the lane's first element
  int last;
  __device__ __forceinline__ void load_k(int t, float (&x)[E]) const {
    if (t == last) {                         // warp-uniform
      load_vec<T, E>(k_new, x);
      return;
    }
    rows.load_k(t, x);
    const float s = ks[rows.page(t)];
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] *= s;
  }
  __device__ __forceinline__ void load_v(int t, float (&x)[E]) const {
    if (t == last) {
      load_vec<T, E>(v_new, x);
      return;
    }
    rows.load_v(t, x);
    const float s = vs[rows.page(t)];
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] *= s;
  }
};

// The CTA of (KV head kh, slot b): attends q[b, kh*G : (kh+1)*G] over rows
// [0, len) of `rows` and writes out[b, kh*G : (kh+1)*G].  blockDim.x must
// be kDecodeWarps * 32.
template <typename T, int D, int G, class Rows>
__device__ __forceinline__ void decode_attention_cta(
    const T* __restrict__ q, const Rows& rows, T* __restrict__ out, int b,
    int kh, int H, int len, float scale, float softcap) {
  constexpr int E = D / 32;                  // elements of a row per lane
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;

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

  for (int c0 = w * 32; c0 < len; c0 += kDecodeWarps * 32) {
    const int n = min(32, len - c0);         // >= 1, warp-uniform
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = -CUDART_INF_F;
    // scores: lane j ends up holding the scores of token c0 + j
    for (int j = 0; j < n; ++j) {
      float kf[E];
      rows.load_k(c0 + j, kf);
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
      float vf[E];
      rows.load_v(c0 + j, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float pj = __shfl_sync(0xffffffffu, sc[g], j);
#pragma unroll
        for (int i = 0; i < E; ++i) acc[g][i] = fmaf(pj, vf[i], acc[g][i]);
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kDecodeWarps][G];
  __shared__ float sm_l[kDecodeWarps][G];
  __shared__ float sm_acc[kDecodeWarps][G][D];
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
    for (int ww = 0; ww < kDecodeWarps; ++ww) M = fmaxf(M, sm_m[ww][g]);
    float Lsum = 0.f, A = 0.f;
    if (M != -CUDART_INF_F) {
#pragma unroll
      for (int ww = 0; ww < kDecodeWarps; ++ww) {
        const float f = expf(sm_m[ww][g] - M);
        Lsum += f * sm_l[ww][g];
        A += f * sm_acc[ww][g][d];
      }
    }
    out[((long long)b * H + kh * G + g) * D + d] = from_f<T>(A / fmaxf(Lsum, 1e-30f));
  }
}

}  // namespace rt

// Instantiates `LAUNCH(D, G)` for every (D, G) the wrappers admit and
// returns true from the enclosing function, or falls through.
#define RT_DECODE_SHAPES(D_, G_, LAUNCH)                                     \
  RT_DECODE_CASE(64, 1, D_, G_, LAUNCH) RT_DECODE_CASE(64, 2, D_, G_, LAUNCH) \
  RT_DECODE_CASE(64, 4, D_, G_, LAUNCH) RT_DECODE_CASE(64, 8, D_, G_, LAUNCH) \
  RT_DECODE_CASE(128, 1, D_, G_, LAUNCH) RT_DECODE_CASE(128, 2, D_, G_, LAUNCH) \
  RT_DECODE_CASE(128, 4, D_, G_, LAUNCH) RT_DECODE_CASE(128, 8, D_, G_, LAUNCH)
#define RT_DECODE_CASE(DD, GG, D_, G_, LAUNCH) \
  if (D_ == DD && G_ == GG) {                  \
    LAUNCH(DD, GG);                            \
    return true;                               \
  }
