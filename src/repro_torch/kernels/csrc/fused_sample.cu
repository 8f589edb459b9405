// Fused LM head + top-k + logsumexp for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fused_sample` (`_fused_sample_kernel`) of
// src/repro/kernels/ragged_decode_attention.py: logits = x @ W (softcapped)
// for every vocab entry, reduced to the top-k values and indices (lowest
// index first on ties) and the logsumexp, without writing (B, V) logits.
//
// What bounds it on the H100: bytes.  The head W (Dm x V) is read once per
// decode step: for Qwen3-0.6B, 1024 x 151936 bf16 = 311 MB, ~93 us at
// 3.35 TB/s, against ~10 GFLOP for 32 slots.  W is read through its
// strides: a tied head passes embed.T (a view of the (V, Dm) embedding,
// d contiguous), an untied one its (Dm, V) lm_head (v contiguous).
//
// bf16 (the serve dtype): `sample_wgmma_kernel<N, TIED>`, one launch a call
// (csrc/hopper.cuh holds its building blocks):
//   * W is wgmma's A operand, 64 vocabulary rows a warpgroup, and x its B
//     operand, N = the batch rows padded to 8 (8..64): the accumulator is
//     64 x N f32 (N / 2 registers a thread), so the batch never competes
//     with W for shared memory and W is read once for every B up to 64
//     (more rows take further passes, each a launch, planned and counted by
//     the wrapper);
//   * a persistent grid, one CTA an SM (`grid` of the plan, at most the
//     number of tiles), walks vocabulary tiles of 128 rows, tile c = CTA +
//     j * grid, so that the CTAs end within one tile of each other; each
//     tile is Dm / 64 stages of a ring in shared memory;
//   * loads by TMA (2-D tensor maps over W in either layout and over x,
//     encoded per call): one thread of the producer warp keeps `stages`
//     stages in flight, each a 128-row x 64-d W tile (the tied [v][d] tile
//     one K-major box; the untied [d][v] tile two MN-major boxes of 64
//     vocabulary columns, read through A's transpose flag) with a full and
//     an empty `mbarrier`; x's 64-column slice rides in each stage beside
//     the W tile (read again from L2 once per 128 rows of W, not from
//     device memory: staging x whole beside a shorter ring, tried at the
//     narrow heads, was no faster);
//   * two consumer warpgroups, each `wgmma` m64nNk16 over its 64 rows of the
//     stage (4 k-steps), release the stage when its products are done;
//     after a tile's last stage each stores its 64 x N logits to shared
//     memory and every thread takes one batch column and a stride of its
//     rows: softcap, a running (max, sum) and a running top-k, entered only
//     by values that beat its last entry, kept in shared memory as (value
//     desc, index asc); rows past V take no part.  The producer goes on
//     loading the next tile's stages meanwhile;
//   * the merge is in the kernel: each CTA merges its threads' partials,
//     one warp a column, into one partial per (column, CTA) in the
//     workspace; the last CTA to take a ticket on the counter copies the
//     CTAs' partials into its idle ring (16-byte loads from all its
//     threads: merging straight from L2, one dependent load after
//     another, took 20-27 us) and merges them into the outputs, then
//     sets the counter back to 0.
//     The workspace and counter are kept by the wrapper per device and
//     stream (zeroed once): a call allocates nothing but its outputs.
// The plan (N, stages, grid, shared-memory bytes, workspace) comes from the wrapper (`fused_sample.plan`); the C entry
// recomputes the layout and refuses a plan it cannot run.
//
// f32 (test shapes only): `chunk_kernel`, one CTA per (vocab chunk of 128,
// group of 32 rows), f32 FMAs from shared memory, one partial per chunk in
// the workspace, then `merge_kernel`.

#include "hopper.cuh"

#include <limits.h>

using namespace rt;

namespace {

constexpr int BM = 32, VC = 128, KT = 32, kThreads = 256, KMAX = 16;

__global__ void __launch_bounds__(kThreads)
chunk_kernel(const float* __restrict__ x, const float* __restrict__ w,
             long long sd, long long sv, float* __restrict__ pmax,
             float* __restrict__ psum,
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
      xs[r][kk] = (row < B && d < Dm) ? x[(long long)row * Dm + d] : 0.f;
    }
    for (int idx = tid; idx < KT * VC; idx += kThreads) {
      int kk, vv;
      if (sd == 1) { kk = idx % KT; vv = idx / KT; }   // d contiguous (embed.T)
      else { vv = idx % VC; kk = idx / VC; }           // v contiguous (lm_head)
      const int d = k0 + kk, vi = v0 + vv;
      ws[kk][vv] = (d < Dm && vi < V) ? w[d * sd + vi * sv] : 0.f;
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


// -- bf16: TMA ring, wgmma, persistent CTAs, the merge in the kernel ----------

constexpr int kVT = 128;             // vocabulary rows a tile (64 a consumer)
constexpr int kDT = 64;              // d a stage (one 128-byte swizzled row)
constexpr int kMaxN = 64;            // x rows a pass
constexpr int kMaxStages = 8;
constexpr int kWTile = kVT * kDT * 2;           // 16 KB
constexpr int kEpiStride = 68;       // floats a column of the logit tile
constexpr int kHeadThreads = 256 + 32;          // 2 consumer warpgroups + 1
constexpr size_t kSmemMax = 232448;             // per block, H100

// Byte offsets of the dynamic shared memory, after aligning its base to
// 1024 (the 128-byte swizzle's repeat): the ring at 0 (a stage: a 16 KB W
// tile, then x's slice of N rows x 128 bytes), the two logit tiles (N
// columns of 64 rows a warpgroup), the threads' top-k lists (value, then
// index), their (max, sum), the barriers (full and empty a stage) and the
// ticket's flag.  The wrapper's `fused_sample.head_smem_bytes` computes
// the same total.
struct HeadSmem {
  size_t stage, epi, lv, li, pm, ps, bars, flag, total;
  __host__ __device__ HeadSmem(int n, int k, int stages) {
    const int parts = 2 * (128 / n);       // partials a column in a CTA
    stage = kWTile + (size_t)n * 128;
    epi = stages * stage;
    lv = epi + 2 * sizeof(float) * n * kEpiStride;
    li = lv + sizeof(float) * n * parts * k;
    pm = li + sizeof(int) * n * parts * k;
    ps = pm + sizeof(float) * n * parts;
    bars = ps + sizeof(float) * n * parts;
    flag = bars + 8 * 2 * stages;
    total = 1024 + flag + 16;
  }
};

// f32 of one column's record in the workspace: a partial (max, sum, K
// values, K indices) from each of the G CTAs, padded to 16 bytes.
__host__ __device__ __forceinline__ int head_record_floats(int G, int K) {
  return (G * (2 + 2 * K) + 3) / 4 * 4;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// (M, S) <- the logsumexp's (max, sum of exp(z - max)) of both.
__device__ __forceinline__ void lse_add(float& M, float& S, float m,
                                        float s) {
  if (m == -CUDART_INF_F) return;
  if (m > M) {
    S = S * expf(M - m) + s;
    M = m;
  } else {
    S += s * expf(m - M);
  }
}

// One warp merges `n` partials of a column (in shared memory), each (max
// m, sum s of exp(z - m)) and a sorted list of K: partial q's at pm[q],
// ps[q], pv[q * K ..].  Returns the logsumexp's (max, sum) on every lane
// and writes the top K to ov / oi from lane 0.  Ties: value desc, index
// asc (every index appears in one partial only).
__device__ void merge_partials(const float* pm, const float* ps,
                               const float* pv, const int* pi, int n, int K,
                               float& out_m, float& out_s, float* ov,
                               int* oi) {
  const int lane = threadIdx.x & 31;
  float M = -CUDART_INF_F, S = 0.f;
  if (K == 1) {                               // greedy: no lists
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
    for (int q = lane; q < n; q += 32) {
      lse_add(M, S, pm[q], ps[q]);
      if (better(pv[q], pi[q], bv, bi)) { bv = pv[q]; bi = pi[q]; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, bv, off);
      const int i = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    const float gm = warp_max(M);
    out_s = warp_sum(M == -CUDART_INF_F ? 0.f : S * expf(M - gm));
    out_m = gm;
    if (lane == 0) {
      ov[0] = bv;
      oi[0] = bi;
    }
    return;
  }
  float lv[KMAX];
  int li[KMAX];
#pragma unroll
  for (int t = 0; t < KMAX; ++t) { lv[t] = -CUDART_INF_F; li[t] = INT_MAX; }
  for (int q = lane; q < n; q += 32) {
    lse_add(M, S, pm[q], ps[q]);
    for (int t = 0; t < K; ++t) {             // the partial's list is sorted
      const float v = pv[q * K + t];
      const int i = pi[q * K + t];
      if (!better(v, i, lv[K - 1], li[K - 1])) break;
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
  const float gm = warp_max(M);
  out_s = warp_sum(M == -CUDART_INF_F ? 0.f : S * expf(M - gm));
  out_m = gm;
  int ptr = 0;
  for (int t = 0; t < K; ++t) {               // K rounds of the best head
    float bv = ptr < K ? lv[ptr] : -CUDART_INF_F;
    int bi = ptr < K ? li[ptr] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v = __shfl_xor_sync(0xffffffffu, bv, off);
      const int i = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    if (ptr < K && li[ptr] == bi && bi != INT_MAX) ++ptr;
    if (lane == 0) {
      ov[t] = bv;
      oi[t] = bi;
    }
  }
}

// Sorted insertion of (v, i), known to beat the last of the K entries.
__device__ __forceinline__ void list_insert(float* lv, int* li, int K,
                                            float v, int i) {
  int p = K - 1;
  while (p > 0 && better(v, i, lv[p - 1], li[p - 1])) {
    lv[p] = lv[p - 1];
    li[p] = li[p - 1];
    --p;
  }
  lv[p] = v;
  li[p] = i;
}

template <int N, bool TIED>
__global__ void __launch_bounds__(kHeadThreads, 1)
sample_wgmma_kernel(const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tx,
                    float* __restrict__ vals, int* __restrict__ idx,
                    float* __restrict__ lse, float* __restrict__ ws,
                    int* __restrict__ counter, int B, int Dm, int V, int K,
                    float softcap, int stages) {
  extern __shared__ unsigned char smem_fs[];
  const int KS = (Dm + kDT - 1) / kDT;
  const HeadSmem lay(N, K, stages);
  unsigned char* base = smem_fs + ((1024 - (smem_u32(smem_fs) & 1023)) & 1023);
  const uint32_t sR = smem_u32(base);                     // the ring at 0
  const uint32_t full = sR + (uint32_t)lay.bars, empty = full + 8 * stages;
  int* flag = reinterpret_cast<int*>(base + lay.flag);
  const int ntiles = (V + kVT - 1) / kVT;
  const int P = 128 / N, Q = 2 * P;            // partials a column: Q

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);             // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // -- producer: one thread issues every copy ------------------------------
    if (threadIdx.x != 256) return;
    const uint32_t stage_tx = (uint32_t)lay.stage;
    int it = 0;
    for (int c = blockIdx.x; c < ntiles; c += gridDim.x)
      for (int kt = 0; kt < KS; ++kt, ++it) {
        const int s = it % stages;
        mbar_wait(empty + 8 * s, ((it / stages) & 1) ^ 1);
        const uint32_t dst = sR + s * stage_tx, bar = full + 8 * s;
        // the untied tile's second box is not loaded where it lies past V
        // (its rows are left out of the reductions, whatever they hold)
        const bool half = !TIED && c * kVT + 64 >= V;
        mbar_expect_tx(bar, stage_tx - (half ? kWTile / 2 : 0));
        if (TIED) {                // [128 v][64 d], d contiguous
          tma_load_2d(dst, &tw, bar, kt * kDT, c * kVT);
        } else {                   // two [64 d][64 v] boxes, v contiguous
          tma_load_2d(dst, &tw, bar, c * kVT, kt * kDT);
          if (!half)
            tma_load_2d(dst + kWTile / 2, &tw, bar, c * kVT + 64, kt * kDT);
        }
        tma_load_2d(dst + kWTile, &tx, bar, kt * kDT, 0);
      }
    return;
  }

  // -- consumers: 64 vocabulary rows of each tile a warpgroup -----------------
  // the warpgroup's index through a shuffle, so that the compiler knows
  // every branch around a wgmma to be uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int wt = threadIdx.x & 127, warp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, t = lane & 3;
  float* epi = reinterpret_cast<float*>(base + lay.epi) + wg * N * kEpiStride;
  float* lv_all = reinterpret_cast<float*>(base + lay.lv);
  int* li_all = reinterpret_cast<int*>(base + lay.li);
  float* pm_all = reinterpret_cast<float*>(base + lay.pm);
  float* ps_all = reinterpret_cast<float*>(base + lay.ps);
  // this thread's column of the logit tile and its stride of rows
  const int col = wt % N, part = wt / N;
  const bool scans = part < P && col < B;
  const int q = wg * P + part;
  float* my_v = lv_all + ((long long)col * Q + q) * K;
  int* my_i = li_all + ((long long)col * Q + q) * K;
  if (scans)
    for (int e = 0; e < K; ++e) { my_v[e] = -CUDART_INF_F; my_i[e] = INT_MAX; }
  float run_m = -CUDART_INF_F, run_s = 0.f;
  float thr_v = -CUDART_INF_F;
  int thr_i = INT_MAX;

  constexpr uint32_t kAtom = 8 * 128;          // 8 swizzled rows
  // A: the tied tile's 64 rows (K-major, a k-step 32 bytes into the row);
  // the untied tile's box of 64 vocabulary columns (MN-major, a k-step 16
  // rows of 128 bytes)
  const uint64_t a0 = TIED ? wgmma_desc(sR + wg * 64 * 128, 16, kAtom,
                                        kSwizzle128)
                           : wgmma_desc(sR + wg * (kWTile / 2), kWTile / 2,
                                        kAtom, kSwizzle128);
  constexpr uint32_t a_step = TIED ? 32 : 16 * 128;
  const uint64_t b0 = wgmma_desc(sR + kWTile, 16, kAtom, kSwizzle128);

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int c = blockIdx.x; c < ntiles; c += gridDim.x) {
    for (int kt = 0; kt < KS; ++kt, ++it) {
      const int s = it % stages;
      mbar_wait(full + 8 * s, (it / stages) & 1);
      const uint64_t a = a0 + ((s * lay.stage) >> 4);
      const uint64_t b = b0 + ((s * lay.stage) >> 4);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDT / 16; ++kk)
        wgmma_ss_n<N, TIED ? 0 : 1>(acc, a + ((kk * a_step) >> 4),
                                    b + ((kk * 32) >> 4), kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // the tile's logits: register 4 j + e is vocabulary row 16 warp + g +
    // 8 (e >> 1) of this warpgroup's 64, batch column 8 j + 2 t + (e & 1)
    named_sync(1 + wg, 128);                   // the last tile's reads done
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        epi[(8 * j + 2 * t + (e & 1)) * kEpiStride + 16 * warp + g +
            8 * (e >> 1)] = acc[4 * j + e];
    named_sync(1 + wg, 128);
    if (scans) {
      const int v0 = c * kVT + 64 * wg;
      for (int r = part; r < 64 && v0 + r < V; r += P) {
        float z = epi[col * kEpiStride + r];
        if (softcap > 0.f) z = tanhf(z / softcap) * softcap;
        if (z > run_m) {
          run_s = run_s * expf(run_m - z) + 1.f;
          run_m = z;
        } else {
          run_s += expf(z - run_m);
        }
        if (better(z, v0 + r, thr_v, thr_i)) {
          list_insert(my_v, my_i, K, z, v0 + r);
          thr_v = my_v[K - 1];
          thr_i = my_i[K - 1];
        }
      }
    }
  }

  // this CTA's partial of each column, one warp a column, into the
  // column's record of the workspace: [max G][sum G][values G K][indices
  // G K], `rec` floats (a multiple of 4) a column
  if (scans) {
    pm_all[col * Q + q] = run_m;
    ps_all[col * Q + q] = run_s;
  }
  named_sync(3, 256);
  const int cw = threadIdx.x >> 5, G = gridDim.x;
  const int rec = head_record_floats(G, K);
  for (int b = cw; b < B; b += 8) {
    float m, s;
    float* r = ws + (long long)b * rec;
    merge_partials(pm_all + b * Q, ps_all + b * Q, lv_all + b * Q * K,
                   li_all + b * Q * K, Q, K, m, s, r + 2 * G + blockIdx.x * K,
                   reinterpret_cast<int*>(r + 2 * G + G * K) + blockIdx.x * K);
    if (lane == 0) {
      r[blockIdx.x] = m;
      r[G + blockIdx.x] = s;
    }
  }
  // the last CTA to finish merges every CTA's partials: the records of as
  // many columns as fit in the ring's (now idle) shared memory at a time,
  // copied in 16-byte loads by all its threads, then one warp a column
  __threadfence();
  named_sync(3, 256);
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1) == G - 1;
  named_sync(3, 256);
  if (!*flag) return;
  __threadfence();
  float* sm = reinterpret_cast<float*>(base);
  const int cols = max(1, (int)(lay.lv / (4 * (size_t)rec)));
  for (int b0 = 0; b0 < B; b0 += cols) {
    const int nb = min(cols, B - b0);
    const float4* src = reinterpret_cast<const float4*>(ws + (long long)b0 * rec);
    float4* dst = reinterpret_cast<float4*>(sm);
#pragma unroll 8
    for (int i = threadIdx.x; i < nb * rec / 4; i += 256) dst[i] = __ldcg(src + i);
    named_sync(3, 256);
    for (int b = b0 + cw; b < b0 + nb; b += 8) {
      float m, s;
      const float* r = sm + (b - b0) * rec;
      merge_partials(r, r + G, r + 2 * G,
                     reinterpret_cast<const int*>(r + 2 * G + G * K), G, K,
                     m, s, vals + (long long)b * K, idx + (long long)b * K);
      if (lane == 0) lse[b] = m + logf(fmaxf(s, 1e-30f));
    }
    named_sync(3, 256);
  }
  if (threadIdx.x == 0) *counter = 0;          // ready for the next launch
}

// 2-D map over a bf16 matrix with `inner` contiguous elements a row (row
// stride `row_stride` elements), cut in 64-column boxes of `box_rows` rows
// under the 128-byte swizzle; out-of-range rows and columns read as zeros.
bool encode_2d(CUtensorMap* map, const void* base, long long inner,
               long long rows, long long row_stride, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0 ||
      (row_stride * 2) % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_stride * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kDT, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int N, bool TIED>
int launch_head(const void* x, const void* w, long long sd, long long sv,
                void* vals, void* idx, void* lse, void* ws, void* counter,
                int B, int Dm, int V, int K, float softcap, int stages,
                int grid, size_t smem, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_wgmma_kernel<N, TIED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tw, tx;
  const bool ok =
      (TIED ? encode_2d(&tw, w, Dm, V, sv, kVT)
            : encode_2d(&tw, w, V, Dm, sd, kDT)) &&
      encode_2d(&tx, x, Dm, B, Dm, N);
  if (!ok) return (int)cudaErrorInvalidValue;
  sample_wgmma_kernel<N, TIED><<<grid, kHeadThreads, smem, s>>>(
      tw, tx, static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), static_cast<float*>(ws),
      static_cast<int*>(counter), B, Dm, V, K, softcap, stages);
  return (int)cudaGetLastError();
}

template <bool TIED>
int dispatch_n(int n, const void* x, const void* w, long long sd,
               long long sv, void* vals, void* idx, void* lse, void* ws,
               void* counter, int B, int Dm, int V, int K, float softcap,
               int stages, int grid, size_t smem, cudaStream_t s) {
#define RT_HEAD(NN)                                                        \
  case NN:                                                                 \
    return launch_head<NN, TIED>(x, w, sd, sv, vals, idx, lse, ws, counter, \
                                 B, Dm, V, K, softcap, stages, grid, smem, \
                                 s);
  switch (n) {
    RT_HEAD(8) RT_HEAD(16) RT_HEAD(24) RT_HEAD(32)
    RT_HEAD(40) RT_HEAD(48) RT_HEAD(56) RT_HEAD(64)
  }
#undef RT_HEAD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fused_sample_max_k() { return KMAX; }

// x (B,Dm) contiguous; w element (d, v) at w + d*sd + v*sv, same dtype as x;
// vals (B,K) f32, idx (B,K) i32, lse (B,) f32; `ws` a workspace of
// `ws_floats` f32 and `counter` an int32 that is 0 between launches.
//   f32: partials of B x ceil(V / 128) chunks (B * chunks * (2 + 2K)
//     floats) in `ws`; two launches; the plan's arguments are not read.
//   bf16 (sd == 1 or sv == 1, the other a multiple of 8, w and x 16-byte
//     aligned, Dm % 8 == 0, B <= n <= 64): the plan of
//     `fused_sample.plan`: n (x rows padded to 8), `stages`, `grid` CTAs
//     and `smem` bytes, which must equal this side's layout;
//     workspace B records of `head_record_floats(grid, K)`; one launch.
// Returns cudaErrorInvalidValue for what it cannot run, else
// cudaGetLastError() after the launches on `stream`.
extern "C" int fused_sample(const void* x, const void* w, long long sd,
                            long long sv, void* vals, void* idx, void* lse,
                            void* ws, long long ws_floats, void* counter,
                            int B, int Dm, int V, int K, float softcap,
                            int dtype, int n, int stages, int grid,
                            long long smem, void* stream) {
  if (K < 1 || K > KMAX || B < 1 || V < K || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const int NC = (V + VC - 1) / VC;
    const long long BN = (long long)B * NC;
    if (ws_floats < BN * (2 + 2 * K)) return (int)cudaErrorInvalidValue;
    float* pmax = static_cast<float*>(ws);
    float* psum = pmax + BN;
    float* ptv = psum + BN;
    int* pti = reinterpret_cast<int*>(ptv + BN * K);
    chunk_kernel<<<dim3(NC, (B + BM - 1) / BM), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sd, sv,
        pmax, psum, ptv, pti, B, Dm, V, K, softcap);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    merge_kernel<<<B, kThreads, 0, s>>>(pmax, psum, ptv, pti,
                                        static_cast<float*>(vals),
                                        static_cast<int*>(idx),
                                        static_cast<float*>(lse), NC, K);
    return (int)cudaGetLastError();
  }
  if (dtype != kBF16) return (int)cudaErrorInvalidValue;
  const bool tied = sd == 1;
  const int ntiles = (V + kVT - 1) / kVT;
  if (!(tied ? sv % 8 == 0 : (sv == 1 && sd % 8 == 0)) || Dm % 8 != 0 ||
      n % 8 != 0 || n < B || n > kMaxN || stages < 2 ||
      stages > kMaxStages || grid < 1 || grid > ntiles || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  const HeadSmem lay(n, K, stages);
  if ((long long)lay.total != smem || lay.total > kSmemMax ||
      ws_floats < (long long)B * head_record_floats(grid, K))
    return (int)cudaErrorInvalidValue;
  return tied ? dispatch_n<true>(n, x, w, sd, sv, vals, idx, lse, ws, counter,
                                 B, Dm, V, K, softcap, stages, grid,
                                 lay.total, s)
              : dispatch_n<false>(n, x, w, sd, sv, vals, idx, lse, ws,
                                  counter, B, Dm, V, K, softcap, stages,
                                  grid, lay.total, s);
}
