// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention` (`_kernel`) of
// src/repro/kernels/flash_attention.py: causal attention of every prompt
// position over the prompt, GQA (query head h reads KV head h / G), an
// optional sliding window, tanh softcap, and optional segment ids for
// packed prefill (a query sees a key only when their ids are equal; pad
// columns carry -1 and, like any id, match each other).
//
// What bounds it on the H100: operations.  A causal prefill of S tokens
// does ~2 x S^2 x D x H flops over ~4 x S x H x D elements, so for the
// engine's widths (64..2048) it is far above the card's ~295 flop/byte
// balance point.  This first version is the simple, right one:
//   * one CTA per (64-row query tile, head, row of the batch), heaviest
//     (last) query tiles first;
//   * the CTA walks 64-row K/V tiles only inside the causal range and the
//     window, stages each in shared memory as f32 (K transposed, rows
//     padded against bank conflicts), and keeps the online softmax (max,
//     sum, accumulator) in f32 registers, 4 query rows x D/16 columns per
//     thread;
//   * products are plain f32 FMAs, so the tensor cores sit idle: the gap to
//     the bound is the price of that and the first thing a later PR takes
//     (mma.sync / wgmma on bf16 tiles);
//   * the ragged edge (S not a multiple of 64, down to S = 1) is masked,
//     where the TPU kernel asserted S % 128 == 0; a fully masked row
//     gives 0, as both references do.

#include "common.cuh"

using namespace rt;

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256, RM = 4, CN = 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1))
         + sizeof(int) * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ seg,
             T* __restrict__ out, int S, int H, int Kh, int window,
             float scale, float softcap) {
  constexpr int DN = D / 16;                 // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                          // [BQ][D + 1]
  float* Kt = Qs + BQ * (D + 1);             // [D][BK + 1]
  float* Vs = Kt + D * (BK + 1);             // [BK][D]
  float* Ps = Vs + BK * D;                   // [BQ][BK + 1]
  int* segk = reinterpret_cast<int*>(Ps + BQ * (BK + 1));   // [BK]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qt * BQ;
  const long long q_rs = (long long)H * D, kv_rs = (long long)Kh * D;
  const T* qb = q + (long long)b * S * q_rs + (long long)h * D;
  const T* kb = k + (long long)b * S * kv_rs + (long long)kh * D;
  const T* vb = v + (long long)b * S * kv_rs + (long long)kh * D;
  T* ob = out + (long long)b * S * q_rs + (long long)h * D;
  const int* segb = seg ? seg + (long long)b * S : nullptr;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    Qs[r * (D + 1) + d] = s < S ? to_f(qb[s * q_rs + d]) * scale : 0.f;
  }
  int segq[RM];
  float m[RM], l[RM], o[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int s = q0 + ty * RM + i;
    segq[i] = (segb && s < S) ? segb[s] : 0;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DN; ++jd) o[i][jd] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_hi = q_last / BK;             // causal block skip
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                         // readers of the last tile done
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D, s = k0 + c;
      Kt[d * (BK + 1) + c] = s < S ? to_f(kb[s * kv_rs + d]) : 0.f;
      Vs[c * D + d] = s < S ? to_f(vb[s * kv_rs + d]) : 0.f;
    }
    if (segb && tid < BK) segk[tid] = k0 + tid < S ? segb[k0 + tid] : 0;
    __syncthreads();

    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RM], kk[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = Qs[(ty * RM + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kk[j] = Kt[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) sc[i][j] = fmaf(a[i], kk[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qs = q0 + ty * RM + i;
      float rmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int ks = k0 + tx + 16 * j;
        bool ok = ks <= qs && ks < S;
        if (window > 0) ok = ok && (qs - ks < window);
        if (segb) ok = ok && (segq[i] == segk[tx + 16 * j]);
        float s = sc[i][j];
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        s = ok ? s : -CUDART_INF_F;
        sc[i][j] = s;
        rmax = fmaxf(rmax, s);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float m_safe = m_new == -CUDART_INF_F ? 0.f : m_new;
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = sc[i][j] == -CUDART_INF_F ? 0.f : expf(sc[i][j] - m_safe);
        Ps[(ty * RM + i) * (BK + 1) + tx + 16 * j] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      const float alpha = m[i] == -CUDART_INF_F ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DN; ++jd) o[i][jd] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) p[i] = Ps[(ty * RM + i) * (BK + 1) + c];
#pragma unroll
      for (int jd = 0; jd < DN; ++jd) {
        const float vv = Vs[c * D + tx + 16 * jd];
#pragma unroll
        for (int i = 0; i < RM; ++i) o[i][jd] = fmaf(p[i], vv, o[i][jd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qs = q0 + ty * RM + i;
    if (qs >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < DN; ++jd)
      ob[qs * q_rs + tx + 16 * jd] = from_f<T>(o[i][jd] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* seg,
           void* out, int B, int S, int H, int Kh, int window, float softcap,
           cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t bytes = smem_bytes<D>();
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int nq = (S + BQ - 1) / BQ;
  flash_kernel<T, D><<<dim3(nq, H, B), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(seg),
      static_cast<T*>(out), S, H, Kh, window, 1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const void* seg, void* out, int B, int S, int H, int Kh,
             int window, float softcap, cudaStream_t s) {
  if (D == 64) return launch<T, 64>(q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  if (D == 128) return launch<T, 128>(q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q (B,S,H,D), k/v (B,S,Kh,D) of dtype `dtype`, contiguous; seg (B,S)
// int32 or null; out (B,S,H,D).  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for an unsupported head dim or dtype).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               const void* seg, void* out, int B, int S, int H,
                               int Kh, int D, int window, float softcap,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch<float>(D, q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(D, q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
