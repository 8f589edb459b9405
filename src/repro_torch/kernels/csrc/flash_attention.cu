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
// balance point: the products belong on the tensor cores.
//
// bf16 (the serve dtype): `flash_tc_kernel`.
//   * one CTA of 4 warps per (64-row query tile, head, row of the batch),
//     heaviest (last) query tiles first; each warp owns 16 query rows (the
//     loops over m-tiles let a warp own more; see kFlashMT);
//   * S = Q K^T and O += P V are `mma.sync.m16n8k16` with bf16 operands
//     and f32 accumulators (csrc/mma.cuh).  Q fragments come from the
//     staged Q tile through `ldmatrix` at each k-step, K fragments from
//     its D-contiguous rows (plain `ldmatrix`), V fragments through
//     `ldmatrix.trans`; P goes from the score accumulators to A fragments
//     in registers, rounded to bf16 (the Pallas body keeps P in f32; the
//     reference's own decode oracle rounds its weights the same way);
//   * K and V tiles of 64 rows (32 at D = 192 and 256) stream through a
//     two-stage `cp.async` ring in swizzled shared memory, 16 bytes a
//     thread: the next tile's K loads while this tile's scores and softmax
//     run, the next V while this tile's P V runs.  Rows past S are
//     zero-filled by the copy;
//   * the wide heads (Nemotron's D = 192, Gemma2's D = 256) keep the
//     layout: a warp's 16 rows hold D / 2 f32 accumulators a thread (128
//     at D = 256), so their key tile halves to 32 keys (16 score
//     registers, not 32) and the ring to 64 KB, which keeps two CTAs on an
//     SM.  A row of 24 chunks (D = 192) swizzles within its groups of 8
//     (24 is a multiple of 8, so every row starts on bank group 0);
//   * Phi-3-Vision's D = 96 is 12 chunks a row: the swizzle XORs a chunk
//     index with row % 8 and would send chunks 8-11 up to chunk 15, into
//     the next row, so a shared tile's row pitch is its chunks rounded up
//     to a multiple of 8 (`flash_pitch`: 16 at D = 96, 4 chunks of each
//     row unused).  Every chunk then stays in its row and 8 rows' same
//     chunk still land in 8 bank groups.  6 k-steps of Q K^T, 12 n-tiles
//     of P V;
//   * masks (causal, only on tiles that cross the diagonal or S; window;
//     segment ids) and softcap act on the score fragment in registers;
//     the online softmax (max, sum, rescale) stays in f32, in the log2
//     domain with the scale folded into the exponent's FMA (`ex2.approx`).
// About half its time is not the products (`--phase variants` removes
// each product in turn): the softmax, the copies' address arithmetic and
// the barriers issue the rest.
// The design is `mma.sync`, not `wgmma`: its fragments are the documented
// register layouts above, where a wrong `wgmma` shared-memory descriptor
// fails silently, and it reaches the few-tenths-of-a-millisecond target.
//
// f32 (the card's f32 end-to-end check, and the RL session's tiny LM at
// D = 32): `flash_f32_kernel`, f32 FMAs from shared memory (TF32 would not
// hold the f32 tolerance), 64 x 64 tiles.
//
// Both mask the ragged edge (S not a multiple of 64, down to S = 1),
// where the TPU kernel asserted S % 128 == 0; a fully masked row gives 0,
// as both references do.

#include "mma.cuh"

using namespace rt;

namespace {

constexpr int BQ = 64, BK = 64, kThreads = 256, RM = 4, CN = 4;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * (D + 1) + D * (BK + 1) + BK * D + BQ * (BK + 1))
         + sizeof(int) * BK;
}

// -- f32: FMAs from shared memory -------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 float* __restrict__ out, int S, int H, int Kh, int window,
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
  const float* qb = q + (long long)b * S * q_rs + (long long)h * D;
  const float* kb = k + (long long)b * S * kv_rs + (long long)kh * D;
  const float* vb = v + (long long)b * S * kv_rs + (long long)kh * D;
  float* ob = out + (long long)b * S * q_rs + (long long)h * D;
  const int* segb = seg ? seg + (long long)b * S : nullptr;

  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    Qs[r * (D + 1) + d] = s < S ? qb[s * q_rs + d] * scale : 0.f;
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
      Kt[d * (BK + 1) + c] = s < S ? kb[s * kv_rs + d] : 0.f;
      Vs[c * D + d] = s < S ? vb[s * kv_rs + d] : 0.f;
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
      ob[qs * q_rs + tx + 16 * jd] = o[i][jd] / den;
  }
}

// -- bf16: tensor cores, cp.async ring --------------------------------------

// keys per K/V tile: 64, or 32 for the wide heads (see the header)
template <int D>
__host__ __device__ constexpr int flash_tk() { return D > 128 ? 32 : 64; }
// 16-byte chunks of a shared tile's row: D / 8 rounded up to a multiple
// of 8, so that `swz` (chunk ^ row % 8) stays inside the row (16 at D 96)
template <int D>
__host__ __device__ constexpr int flash_pitch() { return (D / 8 + 7) / 8 * 8; }
constexpr float kLog2e = 1.4426950408889634f;

// 4 warps of 1 m-tile (16 query rows each): 64 query rows a CTA, a 2-stage
// K/V ring.  Two m-tiles a warp run faster but need 255 registers and
// spill at D = 128; `chip_smoke.py --phase variants` times the choices.
constexpr int kFlashWarps = 4, kFlashMT = 1, kFlashStages = 2;

template <int D>
constexpr size_t tc_smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(8 * flash_pitch<D>()) *
         (16 * kFlashMT * kFlashWarps + 2 * kFlashStages * flash_tk<D>());
}

// Async copy of ROWS rows [r0, r0 + ROWS) of a (S, row_stride) bf16 matrix
// (D elements a row) into a swizzled tile of ROWS rows of flash_pitch<D>()
// chunks; rows >= S are zeros.
// The trip count is a constant, so the loop unrolls; where THREADS is a
// multiple of DC a thread's chunk column and swizzle stay fixed across it
// (D = 192, DC = 24: each trip recomputes them).
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long row_stride, int r0,
                                          int S) {
  constexpr int DC = D / 8, PC = flash_pitch<D>();
  if constexpr (THREADS % DC == 0) {
    constexpr int STEP = THREADS / DC;
    static_assert(ROWS % STEP == 0, "tile shape");
    const int c = threadIdx.x % DC, r_lo = threadIdx.x / DC;
#pragma unroll
    for (int j = 0; j < ROWS / STEP; ++j) {
      const int r = r_lo + j * STEP, s = r0 + r;
      const bool ok = s < S;
      cp_async16(dst + swz(r, c, PC), base + (ok ? s * row_stride : 0) + c * 8,
                 ok ? 16 : 0);
    }
  } else {
    static_assert(ROWS * DC % THREADS == 0, "tile shape");
#pragma unroll
    for (int j = 0; j < ROWS * DC / THREADS; ++j) {
      const int i = (int)threadIdx.x + j * THREADS;
      const int r = i / DC, c = i % DC, s = r0 + r;
      const bool ok = s < S;
      cp_async16(dst + swz(r, c, PC), base + (ok ? s * row_stride : 0) + c * 8,
                 ok ? 16 : 0);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kFlashWarps * 32, 2)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const int* __restrict__ seg, __nv_bfloat16* __restrict__ out,
                int S, int H, int Kh, int window, float scale, float softcap) {
  constexpr int NW = kFlashWarps, MT = kFlashMT, STAGES = kFlashStages;
  constexpr int TK = flash_tk<D>();
  constexpr int WR = 16 * MT, TQ = WR * NW, THREADS = 32 * NW;
  constexpr int PC = flash_pitch<D>();  // 16-byte chunks of a tile's row
  constexpr int KD = D / 16;      // k-steps of Q K^T
  constexpr int NS = TK / 8;      // score n-tiles (8 keys each)
  constexpr int ND = D / 8;       // output n-tiles (8 columns each)
  constexpr uint32_t kTile = TK * PC * 16;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t sQ = smem_u32(smem_tc);
  const uint32_t sK = sQ + TQ * PC * 16;    // [STAGES][TK][PC chunks]
  const uint32_t sV = sK + STAGES * kTile;  // [STAGES][TK][PC chunks]

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Kh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * TQ;
  const long long q_rs = (long long)H * D, kv_rs = (long long)Kh * D;
  const __nv_bfloat16* qb = q + (long long)b * S * q_rs + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * S * kv_rs + (long long)kh * D;
  const __nv_bfloat16* vb = v + (long long)b * S * kv_rs + (long long)kh * D;
  __nv_bfloat16* ob = out + (long long)b * S * q_rs + (long long)h * D;
  const int* segb = seg ? seg + (long long)b * S : nullptr;

  const int q_last = min(q0 + TQ, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / TK : 0;
  const int nt = q_last / TK - kt_lo + 1;  // causal block skip

  // commit groups, in order: {Q, K_0}, {V_0}, ..., {K_S-2}, {V_S-2}, then
  // per tile i {K_i+S-1} (at its top) and {V_i+S-1} (before its P V)
  load_rows<D, TQ, THREADS>(sQ, qb, q_rs, q0, S);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nt)
      load_rows<D, TK, THREADS>(sK + st * kTile, kb, kv_rs, (kt_lo + st) * TK, S);
    cp_async_commit();
    if (st < nt)
      load_rows<D, TK, THREADS>(sV + st * kTile, vb, kv_rs, (kt_lo + st) * TK, S);
    cp_async_commit();
  }

  // this thread's rows: wr0 + 16 mt + g + 8 h, for m-tile mt and half h
  const int wr0 = q0 + warp * WR;
  int segq[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wr0 + 16 * mt + g + 8 * hh;
      segq[mt][hh] = segb && r < S ? segb[r] : 0;
    }
  // the running max m is kept in the log2 domain: p = 2^(x * mul - m),
  // x the raw score (mul = scale * log2 e) or, with softcap, the capped
  // score already in the log2 domain (mul = 1)
  const float mul = softcap > 0.f ? 1.f : scale * kLog2e;
  float o[MT][ND][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
    m[mt][0] = m[mt][1] = -CUDART_INF_F;
    l[mt][0] = l[mt][1] = 0.f;
  }

  for (int it = 0; it < nt; ++it) {
    const int k0 = (kt_lo + it) * TK, st = it % STAGES;
    const int nx = it + STAGES - 1;        // the tile to prefetch
    if (nx < nt)
      load_rows<D, TK, THREADS>(sK + (nx % STAGES) * kTile, kb, kv_rs,
                                (kt_lo + nx) * TK, S);
    cp_async_commit();
    cp_async_wait<2 * STAGES - 2>();       // Q and K_it have landed
    __syncthreads();

    // S = Q K^T for this warp's WR rows x 64 keys; each K fragment feeds
    // the MT m-tiles
    float sc[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][j][e] = 0.f;
    const uint32_t kt_s = sK + st * kTile;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(qa[mt], sQ + swz(warp * WR + 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1),
                                     2 * kk + (lane >> 4), PC));
#pragma unroll
      for (int p = 0; p < NS / 2; ++p) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt_s + swz(16 * p + (lane & 7) + 8 * (lane >> 4),
                                   2 * kk + ((lane >> 3) & 1), PC));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(sc[mt][2 * p], qa[mt], kf[0], kf[1]);
          mma_bf16(sc[mt][2 * p + 1], qa[mt], kf[2], kf[3]);
        }
      }
    }

    // softcap (a warp-uniform branch around the loop), then masks on the
    // fragment: element (mt, j, e) is row wr0 + 16 mt + g + 8 (e >> 1),
    // key k0 + 8 j + 2 t + (e & 1)
    if (softcap > 0.f) {
      const float cs = scale / softcap, cl = softcap * kLog2e;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[mt][j][e] = tanhf(sc[mt][j][e] * cs) * cl;
    }
    const bool full = k0 + TK - 1 <= wr0 && k0 + TK <= S && window == 0 &&
                      segb == nullptr;     // warp-uniform
    if (!full) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ks = k0 + 8 * j + 2 * t + (e & 1);
            const int qs = wr0 + 16 * mt + g + 8 * (e >> 1);
            bool ok = ks <= qs && ks < S;
            if (window > 0) ok = ok && qs - ks < window;
            if (segb) ok = ok && ks < S && segb[ks] == segq[mt][e >> 1];
            if (!ok) sc[mt][j][e] = -CUDART_INF_F;
          }
    }
    // online softmax per row: the 4 threads of a quad share a row
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mx = fmaxf(mx, fmaxf(sc[mt][j][2 * r], sc[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][r], mx * mul);
        const float ms = m_new == -CUDART_INF_F ? 0.f : m_new;
        const float alpha = fast_exp2(m[mt][r] - ms);   // 0 while m = -inf
        float rsum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = fast_exp2(fmaf(sc[mt][j][e], mul, -ms));  // 0 if masked
            sc[mt][j][e] = p;
            rsum += p;
          }
        rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
        rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
        l[mt][r] = l[mt][r] * alpha + rsum;
        m[mt][r] = m_new;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          o[mt][j][2 * r] *= alpha;
          o[mt][j][2 * r + 1] *= alpha;
        }
      }

    if (nx < nt)
      load_rows<D, TK, THREADS>(sV + (nx % STAGES) * kTile, vb, kv_rs,
                                (kt_lo + nx) * TK, S);
    cp_async_commit();
    cp_async_wait<2 * STAGES - 2>();       // V_it has landed
    __syncthreads();

    // O += P V: P (WR x 64) from the score registers, 16 keys a k-step;
    // each V fragment feeds the MT m-tiles
    const uint32_t vt_s = sV + st * kTile;
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = pack_bf16(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
        pa[mt][1] = pack_bf16(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
        pa[mt][2] = pack_bf16(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
        pa[mt][3] = pack_bf16(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int p = 0; p < ND / 2; ++p) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt_s + swz(16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1),
                                         2 * p + (lane >> 4), PC));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * p], pa[mt], vf[0], vf[1]);
          mma_bf16(o[mt][2 * p + 1], pa[mt], vf[2], vf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wr0 + 16 * mt + g + 8 * r;
      if (row >= S) continue;
      const float inv = 1.f / fmaxf(l[mt][r], 1e-30f);
      __nv_bfloat16* orow = ob + row * q_rs + 2 * t;
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) = __floats2bfloat162_rn(
            o[mt][j][2 * r] * inv, o[mt][j][2 * r + 1] * inv);
    }
}

// -- launchers ----------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  configured = e == cudaSuccess;
  return (int)e;
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* seg,
               void* out, int B, int S, int H, int Kh, int window,
               float softcap, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t bytes = smem_bytes<D>();
  if (int e = set_smem(flash_f32_kernel<D>, bytes, configured)) return e;
  const int nq = (S + BQ - 1) / BQ;
  flash_f32_kernel<D><<<dim3(nq, H, B), kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(seg),
      static_cast<float*>(out), S, H, Kh, window, 1.0f / sqrtf((float)D),
      softcap);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* seg,
                void* out, int B, int S, int H, int Kh, int window,
                float softcap, cudaStream_t stream) {
  static bool configured = false;
  constexpr size_t bytes = tc_smem_bytes<D>();
  if (int e = set_smem(flash_tc_kernel<D>, bytes, configured)) return e;
  constexpr int TQ = 16 * kFlashMT * kFlashWarps;
  const int nq = (S + TQ - 1) / TQ;
  flash_tc_kernel<D><<<dim3(nq, H, B), 32 * kFlashWarps, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(out), S, H, Kh, window,
      1.0f / sqrtf((float)D), softcap);
  return (int)cudaGetLastError();
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
  if (dtype == kF32 && D == 32)               // the RL session's tiny LM
    return launch_f32<32>(q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  if (dtype == kF32 && D == 64)
    return launch_f32<64>(q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  if (dtype == kF32 && D == 128)
    return launch_f32<128>(q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  if (dtype == kBF16 && D == 64)
    return launch_bf16<64>(
        q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  if (dtype == kBF16 && D == 96)              // Phi-3-Vision-4.2B
    return launch_bf16<96>(
        q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  if (dtype == kBF16 && D == 128)
    return launch_bf16<128>(
        q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  if (dtype == kBF16 && D == 192)             // Nemotron-4-340B
    return launch_bf16<192>(
        q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  if (dtype == kBF16 && D == 256)             // Gemma2-2B
    return launch_bf16<256>(
        q, k, v, seg, out, B, S, H, Kh, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
