// Fused LM head + top-k + logsumexp for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_sample` (`_fused_sample_kernel`) of
// src/repro/kernels/ragged_decode_attention.py: logits = x @ W (softcapped)
// for every vocab entry, reduced to the top-k values and indices (lowest
// index first on ties) and the logsumexp, without writing (B, V) logits.
//
// What bounds it on the H100: bytes.  The head W (Dm x V) is read once per
// decode step: for Qwen3-0.6B, 1024 x 151936 bf16 = 311 MB, ~93 us at
// 3.35 TB/s, against ~10 GFLOP for 32 slots.  The design:
//   * W is read through its strides, so a tied head passes embed.T (a view
//     of the (V, Dm) embedding) and nothing is transposed in memory; the
//     tile loader walks the contiguous axis with consecutive threads;
//   * pass 1: one CTA per (vocab chunk of 128, group of 32 rows), so a W
//     tile is staged in shared memory once and used by every row of the
//     batch; f32 FMAs from shared memory, 4 x 4 outputs a thread; each
//     warp then holds whole rows of its chunk and writes the chunk's max,
//     sum of exp and top-k to a small scratch;
//   * pass 2: one CTA per row merges the chunks: a running logsumexp and a
//     k-way selection under (value desc, index asc), so ties resolve as
//     `lax.top_k` and `argmax` do, whatever order the chunks finish in.
// Not yet done (later work): tensor-core products, keeping x in registers
// across chunks, one persistent pass.

#include "common.cuh"

#include <limits.h>

using namespace rt;

namespace {

constexpr int BM = 32, VC = 128, KT = 32, kThreads = 256, KMAX = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_kernel(const T* __restrict__ x, const T* __restrict__ w, long long sd,
             long long sv, float* __restrict__ pmax, float* __restrict__ psum,
             float* __restrict__ ptv, int* __restrict__ pti, int B, int Dm,
             int V, int K, float softcap) {
  __shared__ float xs[BM][KT + 1];
  __shared__ float ws[KT][VC + 1];
  const int c = blockIdx.x, NC = gridDim.x;
  const int row0 = blockIdx.y * BM, v0 = c * VC;
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;   // warp = ty
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Dm; k0 += KT) {
    __syncthreads();
    for (int idx = tid; idx < BM * KT; idx += kThreads) {
      const int kk = idx % KT, r = idx / KT;
      const int row = row0 + r, d = k0 + kk;
      xs[r][kk] = (row < B && d < Dm) ? to_f(x[(long long)row * Dm + d]) : 0.f;
    }
    for (int idx = tid; idx < KT * VC; idx += kThreads) {
      int kk, vv;
      if (sd == 1) { kk = idx % KT; vv = idx / KT; }   // d contiguous (embed.T)
      else { vv = idx % VC; kk = idx / VC; }           // v contiguous (lm_head)
      const int d = k0 + kk, vi = v0 + vv;
      ws[kk][vv] = (d < Dm && vi < V) ? to_f(w[d * sd + vi * sv]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KT; ++kk) {
      float a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = ws[kk][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
    }
  }

  // warp ty holds rows ty*4 .. ty*4+3 of the chunk, lane tx columns tx+32j
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= B) break;                     // warp-uniform
    float s[4];
    bool taken[4];
    float cmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int vi = v0 + tx + 32 * j;
      float z = acc[i][j];
      if (softcap > 0.f) z = tanhf(z / softcap) * softcap;
      s[j] = vi < V ? z : -CUDART_INF_F;
      taken[j] = false;
      cmax = fmaxf(cmax, s[j]);
    }
    cmax = warp_max(cmax);                   // finite: a chunk has a column
    float csum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      csum += s[j] == -CUDART_INF_F ? 0.f : expf(s[j] - cmax);
    csum = warp_sum(csum);
    const long long base = (long long)row * NC + c;
    if (tx == 0) {
      pmax[base] = cmax;
      psum[base] = csum;
    }
    for (int t = 0; t < K; ++t) {
      float bv = -CUDART_INF_F;
      int bi = INT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int vi = v0 + tx + 32 * j;
        if (!taken[j] && vi < V && better(s[j], vi, bv, bi)) { bv = s[j]; bi = vi; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v0 + tx + 32 * j == bi) taken[j] = true;
      if (tx == 0) {
        ptv[base * K + t] = bv;
        pti[base * K + t] = bi;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ pmax, const float* __restrict__ psum,
             const float* __restrict__ ptv, const int* __restrict__ pti,
             float* __restrict__ vals, int* __restrict__ idx,
             float* __restrict__ lse, int NC, int K) {
  __shared__ float red_v[kThreads / 32];
  __shared__ float red_l[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const long long base = (long long)b * NC;

  // running logsumexp over this thread's chunks, in chunk order
  float M = -CUDART_INF_F, Ls = 0.f;
  float lv[KMAX];
  int li[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) { lv[t] = -CUDART_INF_F; li[t] = INT_MAX; }
  for (int c = tid; c < NC; c += kThreads) {
    const float cm = pmax[base + c], cs = psum[base + c];
    if (cm > M) { Ls = Ls * expf(M - cm) + cs; M = cm; }
    else Ls += cs * expf(cm - M);
    for (int t = 0; t < K; ++t) {            // insert into the sorted list
      float v = ptv[(base + c) * K + t];
      int i = pti[(base + c) * K + t];
      if (!better(v, i, lv[K - 1], li[K - 1])) break;   // chunk list sorted
      int p = K - 1;
      while (p > 0 && better(v, i, lv[p - 1], li[p - 1])) {
        lv[p] = lv[p - 1];
        li[p] = li[p - 1];
        --p;
      }
      lv[p] = v;
      li[p] = i;
    }
  }
  // block logsumexp
  float gm = warp_max(M);
  float gl = Ls * (M == -CUDART_INF_F ? 0.f : expf(M - gm));
  gl = warp_sum(gl);
  if (lane == 0) { red_v[wp] = gm; red_l[wp] = gl; }
  __syncthreads();
  if (tid == 0) {
    float bm = -CUDART_INF_F;
    for (int i = 0; i < kThreads / 32; ++i) bm = fmaxf(bm, red_v[i]);
    float bl = 0.f;
    for (int i = 0; i < kThreads / 32; ++i)
      bl += red_v[i] == -CUDART_INF_F ? 0.f : red_l[i] * expf(red_v[i] - bm);
    lse[b] = bm + logf(fmaxf(bl, 1e-30f));
  }
  // k rounds of block-wide selection of the best list head
  int ptr = 0;
  for (int t = 0; t < K; ++t) {
    __syncthreads();
    float bv = ptr < K ? lv[ptr] : -CUDART_INF_F;
    int bi = ptr < K ? li[ptr] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[wp] = bv; red_i[wp] = bi; }
    __syncthreads();
    bv = red_v[0];
    bi = red_i[0];
    for (int i = 1; i < kThreads / 32; ++i)
      if (better(red_v[i], red_i[i], bv, bi)) { bv = red_v[i]; bi = red_i[i]; }
    if (ptr < K && li[ptr] == bi && bi != INT_MAX) ++ptr;
    if (tid == 0) {
      vals[(long long)b * K + t] = bv;
      idx[(long long)b * K + t] = bi;
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, long long sd, long long sv,
           void* vals, void* idx, void* lse, void* pmax, void* psum, void* ptv,
           void* pti, int B, int Dm, int V, int K, float softcap,
           cudaStream_t s) {
  const int NC = (V + VC - 1) / VC;
  chunk_kernel<T><<<dim3(NC, (B + BM - 1) / BM), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), sd, sv,
      static_cast<float*>(pmax), static_cast<float*>(psum),
      static_cast<float*>(ptv), static_cast<int*>(pti), B, Dm, V, K, softcap);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_kernel<<<B, kThreads, 0, s>>>(
      static_cast<const float*>(pmax), static_cast<const float*>(psum),
      static_cast<const float*>(ptv), static_cast<const int*>(pti),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), NC, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_sample_vocab_chunk() { return VC; }

extern "C" int fused_sample_max_k() { return KMAX; }

// x (B,Dm) contiguous; w element (d, v) at w + d*sd + v*sv, same dtype as x;
// vals (B,K) f32, idx (B,K) i32, lse (B,) f32; scratch pmax/psum (B,NC) f32
// and ptv/pti (B,NC,K) with NC = ceil(V / 128).  Two launches on `stream`;
// returns cudaGetLastError() after them.
extern "C" int fused_sample(const void* x, const void* w, long long sd,
                            long long sv, void* vals, void* idx, void* lse,
                            void* pmax, void* psum, void* ptv, void* pti, int B,
                            int Dm, int V, int K, float softcap, int dtype,
                            void* stream) {
  if (K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(x, w, sd, sv, vals, idx, lse, pmax, psum, ptv, pti,
                         B, Dm, V, K, softcap, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, w, sd, sv, vals, idx, lse, pmax, psum,
                                 ptv, pti, B, Dm, V, K, softcap, s);
  return (int)cudaErrorInvalidValue;
}
