// The bf16 fused head's earlier design, kept as a variant only:
// `chip_smoke.py --phase variants` builds it (`fused_sample/mma_sync_design`,
// with -I src/repro_torch/kernels/csrc) and times it through its own C
// entry beside the shipped kernel (csrc/fused_sample.cu).  The port never
// builds or calls it.  Unchanged below.
//
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
// bf16 (the serve dtype): `sample_tc_kernel`, one persistent CTA per SM
// (as many as there are 128-wide vocab chunks, at most), each walking the
// chunks c = blockIdx.x + j * gridDim.x:
//   * x (the batch rows, padded to 16) is staged in swizzled shared memory
//     once per CTA, not once per chunk;
//   * W streams through a ring of 4 tiles of 128 vocab x 64 d (16 KB),
//     3 in flight while one is multiplied (deeper rings time the same,
//     `chip_smoke.py --phase variants`), `cp.async` 16 bytes a thread,
//     so each W byte is read from device memory once per step (rows past
//     V and columns past Dm are zero-filled by the copy);
//   * the products are `mma.sync.m16n8k16` (csrc/mma.cuh): x as A, the W
//     tile as B through `ldmatrix` (tied: rows are K-contiguous) or
//     `ldmatrix.trans` (untied); each of the 8 warps owns 16 columns of a
//     chunk, f32 accumulators;
//   * after a chunk's last tile the warp folds its logits into a running
//     logsumexp per (thread, row) and a running top-k per (warp, row) in
//     shared memory, entered only by values that beat the list's last
//     (a warp vote skips the common case), so the CTA, like the Pallas
//     kernel's scratch across its sequential grid, carries its state
//     across its chunks; at the end the CTA merges its warps and writes
//     one partial per row;
//   * the merge pass reads one partial per CTA (132 on an H100), not one
//     per chunk.  Ties stay (value desc, index asc) at every merge.
// Rows beyond what shared memory holds next to x, the ring and the top-k
// lists (64 at Dm = 1024 with k <= 4, 48 up to k = 16) go to further row
// blocks (gridDim.y), which read W again.
// A head too wide to stage x whole even for 16 rows (Dm above ~5k:
// Qwen1.5-110B's 8192, Nemotron-4-340B's 18432) streams x instead: each
// ring stage carries the x slice (rows x the tile's 64 d) beside its W
// tile, so x is read again for every vocab chunk, from L2 (x is 16 KB a
// row at Dm = 8192), while the accumulators of the chunk stay in registers
// across its d tiles as before.  W is still read once.
//
// f32 (test shapes only): `chunk_kernel`, one CTA per (vocab chunk of 128,
// group of 32 rows), f32 FMAs from shared memory, one partial per chunk.

#include "mma.cuh"

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

// -- bf16: tensor cores, persistent CTAs, cp.async ring ----------------------

constexpr int SVC = 128, SKT = 64, kStages = 4, kSWarps = 8;
constexpr int kSThreads = kSWarps * 32;
constexpr uint32_t kWTile = SVC * SKT * 2;        // 16 KB
constexpr size_t kSmemMax = 232448;               // per block, H100

struct SampleSmem {                    // byte offsets of the dynamic buffer
  size_t w, lv, li, wm, ws, total;
  // x staged whole (bm x dmp), or streamed: one bm x SKT slice a stage
  __host__ __device__ SampleSmem(int bm, int dmp, int k, bool stream) {
    w = stream ? (size_t)kStages * bm * SKT * 2 : (size_t)bm * dmp * 2;
    lv = w + kStages * (size_t)kWTile;
    li = lv + sizeof(float) * kSWarps * bm * k;
    wm = li + sizeof(int) * kSWarps * bm * k;
    ws = wm + sizeof(float) * kSWarps * bm;
    total = ws + sizeof(float) * kSWarps * bm;
  }
};

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

template <int MT, bool TIED, bool STREAM>
__global__ void __launch_bounds__(kSThreads, 1)
sample_tc_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w, long long sd,
                 long long sv, float* __restrict__ pmax,
                 float* __restrict__ psum, float* __restrict__ ptv,
                 int* __restrict__ pti, int B, int Dm, int Dmp, int V, int K,
                 float softcap) {
  constexpr int BM = MT * 16;
  constexpr uint32_t kXTile = BM * SKT * 2;       // streamed x: one slice
  extern __shared__ __align__(128) unsigned char smem[];
  const SampleSmem lay(BM, Dmp, K, STREAM);
  const uint32_t sX = smem_u32(smem);
  const uint32_t sW = sX + (uint32_t)lay.w;
  float* lv_all = reinterpret_cast<float*>(smem + lay.lv);   // [warp][BM][K]
  int* li_all = reinterpret_cast<int*>(smem + lay.li);
  float* wm = reinterpret_cast<float*>(smem + lay.wm);       // [warp][BM]
  float* wsum = reinterpret_cast<float*>(smem + lay.ws);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BM;
  const int NC = (V + SVC - 1) / SVC, NP = gridDim.x;
  const int XC = Dmp / 8, KTILES = Dmp / SKT;
  const int T = (NC - (int)blockIdx.x + NP - 1) / NP * KTILES;

  // x once per CTA (unless it streams): rows >= B and columns >= Dm are
  // zeros
  if (!STREAM) {
    for (int i = threadIdx.x; i < BM * XC; i += kSThreads) {
      const int r = i / XC, c = i % XC, row = row0 + r;
      const bool ok = row < B && c * 8 < Dm;
      cp_async16(sX + swz(r, c, XC), x + (ok ? (long long)row * Dm + c * 8 : 0),
                 ok ? 16 : 0);
    }
  }
  auto load_w = [&](int tile, int slot) {
    const int v0 = ((int)blockIdx.x + tile / KTILES * NP) * SVC;
    const int d0 = tile % KTILES * SKT;
    const uint32_t dst = sW + slot * kWTile;
    if (STREAM) {              // x's [BM rows][64 d] slice of this tile
      for (int i = threadIdx.x; i < BM * (SKT / 8); i += kSThreads) {
        const int r = i >> 3, c = i & 7, row = row0 + r, d = d0 + c * 8;
        const bool ok = row < B && d < Dm;
        cp_async16(sX + slot * kXTile + swz(r, c, 8),
                   x + (ok ? (long long)row * Dm + d : 0), ok ? 16 : 0);
      }
    }
    for (int i = threadIdx.x; i < SVC * SKT / 8; i += kSThreads) {
      if (TIED) {              // [128 vocab rows][64 d], d contiguous
        const int r = i >> 3, c = i & 7, vi = v0 + r, d = d0 + c * 8;
        const bool ok = vi < V && d < Dm;
        cp_async16(dst + swz(r, c, 8), w + (ok ? vi * sv + d : 0),
                   ok ? 16 : 0);
      } else {                 // [64 d rows][128 vocab], vocab contiguous
        const int r = i >> 4, c = i & 15, d = d0 + r, vi = v0 + c * 8;
        const int n = d < Dm ? min(8, V - vi) : 0;
        cp_async16(dst + swz(r, c, 16), w + (n > 0 ? d * sd + vi : 0),
                   n > 0 ? 2 * n : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T) load_w(s, s);
    cp_async_commit();                     // staged x travels with tile 0
  }

  float* lv = lv_all + warp * BM * K;
  int* li = li_all + warp * BM * K;
  for (int i = lane; i < BM * K; i += 32) {
    lv[i] = -CUDART_INF_F;
    li[i] = INT_MAX;
  }
  __syncwarp();
  // per (m-tile, half): this thread's row mt * 16 + g + 8 * h
  float acc[MT][2][4], rm[MT][2], rs[MT][2], tv[MT][2];
  int ti[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rm[mt][h] = tv[mt][h] = -CUDART_INF_F;
      rs[mt][h] = 0.f;
      ti[mt][h] = INT_MAX;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][h][e] = 0.f;
    }

  for (int tile = 0; tile < T; ++tile) {
    cp_async_wait<kStages - 2>();          // this tile (and x) landed
    __syncthreads();                       // ... and the slot to refill is free
    if (tile + kStages - 1 < T)
      load_w(tile + kStages - 1, (tile + kStages - 1) % kStages);
    cp_async_commit();
    const uint32_t wt = sW + (tile % kStages) * kWTile;
    const int kt = tile % KTILES;
#pragma unroll
    for (int kk = 0; kk < SKT / 16; ++kk) {
      uint32_t bw[4];
      if (TIED)
        ldmatrix_x4(bw, wt + swz(warp * 16 + (lane & 7) + 8 * (lane >> 4),
                                 2 * kk + ((lane >> 3) & 1), 8));
      else
        ldmatrix_x4_trans(bw, wt + swz(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                                       2 * warp + (lane >> 4), 16));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        const int ar = mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
        if (STREAM)
          ldmatrix_x4(a, sX + (tile % kStages) * kXTile +
                             swz(ar, 2 * kk + (lane >> 4), 8));
        else
          ldmatrix_x4(a, sX + swz(ar, kt * (SKT / 8) + 2 * kk + (lane >> 4), XC));
        mma_bf16(acc[mt][0], a, bw[0], bw[1]);
        mma_bf16(acc[mt][1], a, bw[2], bw[3]);
      }
    }
    if (kt != KTILES - 1) continue;

    // the chunk is done: acc[mt][nt][e] is row mt*16 + g + 8*(e >> 1),
    // vocab column v0 + warp*16 + nt*8 + 2t + (e & 1)
    const int v0 = ((int)blockIdx.x + tile / KTILES * NP) * SVC + warp * 16;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        const bool row_ok = row0 + r < B;
        float z[4];
        int vi[4];
        bool hit = false;
        float cmax = -CUDART_INF_F;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int nt = c >> 1, e = 2 * h + (c & 1);
          vi[c] = v0 + nt * 8 + 2 * t + (c & 1);
          float s = acc[mt][nt][e];
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          z[c] = row_ok && vi[c] < V ? s : -CUDART_INF_F;
          cmax = fmaxf(cmax, z[c]);
          hit = hit || (z[c] != -CUDART_INF_F &&
                        better(z[c], vi[c], tv[mt][h], ti[mt][h]));
        }
        if (cmax != -CUDART_INF_F) {       // running logsumexp
          const float nm = fmaxf(rm[mt][h], cmax);
          float add = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) add += expf(z[c] - nm);   // 0 if masked
          rs[mt][h] = rs[mt][h] * expf(rm[mt][h] - nm) + add;
          rm[mt][h] = nm;
        }
        if (__any_sync(0xffffffffu, hit)) {  // rare after the first chunk
          float* rl = lv + r * K;
          int* ri = li + r * K;
          for (int q = 0; q < 4; ++q) {      // the quad's threads in turn
            if (t == q && hit) {
              float bv = rl[K - 1];
              int bi = ri[K - 1];
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                if (z[c] != -CUDART_INF_F && better(z[c], vi[c], bv, bi)) {
                  list_insert(rl, ri, K, z[c], vi[c]);
                  bv = rl[K - 1];
                  bi = ri[K - 1];
                }
              }
            }
            __syncwarp();
          }
          tv[mt][h] = rl[K - 1];
          ti[mt][h] = ri[K - 1];
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }

  // this CTA's partial per row: logsumexp over the quad, then the warps
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = rm[mt][h], s = rs[mt][h];
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m, off);
        const float os = __shfl_xor_sync(0xffffffffu, s, off);
        const float nm = fmaxf(m, om);
        if (nm != -CUDART_INF_F)
          s = (m == -CUDART_INF_F ? 0.f : s * expf(m - nm)) +
              (om == -CUDART_INF_F ? 0.f : os * expf(om - nm));
        m = nm;
      }
      if (t == 0) {
        wm[warp * BM + mt * 16 + g + 8 * h] = m;
        wsum[warp * BM + mt * 16 + g + 8 * h] = s;
      }
    }
  __syncthreads();
  const long long NPl = NP;
  for (int r = warp; r < BM && row0 + r < B; r += kSWarps) {
    const long long base = (long long)(row0 + r) * NPl + blockIdx.x;
    float m = lane < kSWarps ? wm[lane * BM + r] : -CUDART_INF_F;
    float s = lane < kSWarps ? wsum[lane * BM + r] : 0.f;
    const float M = warp_max(m);
    s = warp_sum(m == -CUDART_INF_F ? 0.f : s * expf(m - M));
    if (lane == 0) {
      pmax[base] = M;                      // finite: the CTA saw a column
      psum[base] = s;
    }
    // top-k of the 8 warps' lists (8 K <= 128 entries, 4 per lane)
    float cv[4];
    int ci[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = lane + 32 * j;           // entry e of [warp][K]
      const bool in = e < kSWarps * K;
      cv[j] = in ? lv_all[((e / K) * BM + r) * K + e % K] : -CUDART_INF_F;
      ci[j] = in ? li_all[((e / K) * BM + r) * K + e % K] : INT_MAX;
    }
    for (int kk = 0; kk < K; ++kk) {
      float bv = -CUDART_INF_F;
      int bi = INT_MAX, bs = 4 * lane;       // slot: 4 * lane + j
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (better(cv[j], ci[j], bv, bi)) { bv = cv[j]; bi = ci[j]; bs = 4 * lane + j; }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        const int os = __shfl_xor_sync(0xffffffffu, bs, off);
        if (better(ov, oi, bv, bi) || (ov == bv && oi == bi && os < bs)) {
          bv = ov;
          bi = oi;
          bs = os;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (bs == 4 * lane + j) { cv[j] = -CUDART_INF_F; ci[j] = INT_MAX; }
      if (lane == 0) {
        ptv[base * K + kk] = bv;
        pti[base * K + kk] = bi;
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n > 0 ? n : 1;
}

int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Rows per CTA of the bf16 kernel and whether x streams: all of B (padded
// to 16) up to 64, as far as shared memory holds x whole next to the ring
// and the lists; where not even 16 rows fit, x streams through the ring
// with all of B up to 64 rows.
struct TcPlan {
  int rows;
  bool stream;
};

TcPlan tc_plan(int B, int Dm, int K) {
  const int mt_max = min(4, (B + 15) / 16);
  for (int mt = mt_max; mt >= 1; --mt)
    if (SampleSmem(16 * mt, round_up(Dm, SKT), K, false).total <= kSmemMax)
      return {16 * mt, false};
  return {16 * mt_max, true};
}

int partials(int V, int dtype) {
  const int nc = (V + VC - 1) / VC;
  return dtype == kBF16 ? min(nc, sm_count()) : nc;
}

template <int MT, bool TIED, bool STREAM>
int launch_tc(const void* x, const void* w, long long sd, long long sv,
              void* pmax, void* psum, void* ptv, void* pti, int B, int Dm,
              int V, int K, float softcap, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_tc_kernel<MT, TIED, STREAM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemMax);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int Dmp = round_up(Dm, SKT), BM = 16 * MT;
  const SampleSmem lay(BM, Dmp, K, STREAM);
  sample_tc_kernel<MT, TIED, STREAM>
      <<<dim3(partials(V, kBF16), (B + BM - 1) / BM), kSThreads, lay.total, s>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(w), sd, sv,
          static_cast<float*>(pmax), static_cast<float*>(psum),
          static_cast<float*>(ptv), static_cast<int*>(pti), B, Dm, Dmp, V, K,
          softcap);
  return (int)cudaGetLastError();
}

template <bool TIED, bool STREAM>
int dispatch_tc(int BM, const void* x, const void* w, long long sd,
                long long sv, void* pmax, void* psum, void* ptv, void* pti,
                int B, int Dm, int V, int K, float softcap, cudaStream_t s) {
  switch (BM) {
    case 16: return launch_tc<1, TIED, STREAM>(x, w, sd, sv, pmax, psum, ptv, pti, B, Dm, V, K, softcap, s);
    case 32: return launch_tc<2, TIED, STREAM>(x, w, sd, sv, pmax, psum, ptv, pti, B, Dm, V, K, softcap, s);
    case 48: return launch_tc<3, TIED, STREAM>(x, w, sd, sv, pmax, psum, ptv, pti, B, Dm, V, K, softcap, s);
    case 64: return launch_tc<4, TIED, STREAM>(x, w, sd, sv, pmax, psum, ptv, pti, B, Dm, V, K, softcap, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool TIED>
int dispatch_plan(const void* x, const void* w, long long sd, long long sv,
                  void* pmax, void* psum, void* ptv, void* pti, int B, int Dm,
                  int V, int K, float softcap, cudaStream_t s) {
  const TcPlan plan = tc_plan(B, Dm, K);
  return plan.stream
             ? dispatch_tc<TIED, true>(plan.rows, x, w, sd, sv, pmax, psum, ptv, pti, B, Dm, V, K, softcap, s)
             : dispatch_tc<TIED, false>(plan.rows, x, w, sd, sv, pmax, psum, ptv, pti, B, Dm, V, K, softcap, s);
}

}  // namespace

extern "C" int fused_sample_max_k() { return KMAX; }

// Partials per row the scratch must hold: one per vocab chunk of 128 for
// f32, one per CTA of the persistent bf16 kernel (min(SMs, chunks)).
extern "C" int fused_sample_partials(int V, int dtype) {
  return partials(V, dtype);
}

// Rows per CTA of the bf16 kernel at these shapes, negative when x streams
// through the ring instead of being staged whole.
extern "C" int fused_sample_bf16_plan(int B, int Dm, int K) {
  const TcPlan plan = tc_plan(B, Dm, K);
  return plan.stream ? -plan.rows : plan.rows;
}

// x (B,Dm) contiguous; w element (d, v) at w + d*sd + v*sv, same dtype as x
// (bf16: sd == 1 or sv == 1, the other a multiple of 8, w and x 16-byte
// aligned, Dm % 8 == 0); vals (B,K) f32, idx (B,K) i32, lse (B,) f32;
// scratch pmax/psum (B,NP) f32 and ptv/pti (B,NP,K) with NP =
// fused_sample_partials(V, dtype).  Two launches on `stream`; returns
// cudaGetLastError() after them.
extern "C" int fused_sample(const void* x, const void* w, long long sd,
                            long long sv, void* vals, void* idx, void* lse,
                            void* pmax, void* psum, void* ptv, void* pti, int B,
                            int Dm, int V, int K, float softcap, int dtype,
                            void* stream) {
  if (K < 1 || K > KMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int NP = partials(V, dtype);
  int rc;
  if (dtype == kF32) {
    chunk_kernel<<<dim3(NP, (B + BM - 1) / BM), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), sd, sv,
        static_cast<float*>(pmax), static_cast<float*>(psum),
        static_cast<float*>(ptv), static_cast<int*>(pti), B, Dm, V, K,
        softcap);
    rc = (int)cudaGetLastError();
  } else if (dtype == kBF16 && (sd == 1 || sv == 1) && Dm % 8 == 0) {
    rc = sd == 1 ? dispatch_plan<true>(x, w, sd, sv, pmax, psum, ptv, pti, B, Dm, V, K, softcap, s)
                 : dispatch_plan<false>(x, w, sd, sv, pmax, psum, ptv, pti, B, Dm, V, K, softcap, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  merge_kernel<<<B, kThreads, 0, s>>>(
      static_cast<const float*>(pmax), static_cast<const float*>(psum),
      static_cast<const float*>(ptv), static_cast<const int*>(pti),
      static_cast<float*>(vals), static_cast<int*>(idx),
      static_cast<float*>(lse), NP, K);
  return (int)cudaGetLastError();
}
