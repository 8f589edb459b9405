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
// engine's widths (64..32,768) it is far above the card's ~295 flop/byte
// balance point: the products belong on the tensor cores, at the rate
// only `wgmma` reaches.
//
// bf16 (the serve dtype): `flash_wgmma_kernel`, one design for D 64, 96,
// 128, 192 and 256 (csrc/hopper.cuh holds its building blocks).
//   * one CTA per (query tile, head, row of the batch), heaviest (last)
//     query tiles first over the whole grid; warpgroup 0 is the producer,
//     warpgroups 1..kFlashConsumers the consumers, each owning 64 query
//     rows (a query tile is 128 rows with the 2 consumers shipped);
//   * loads by TMA: one thread of the producer issues
//     `cp.async.bulk.tensor` boxes of the Q tile (once) and of each K and
//     V tile into a ring of `kFlashStages` (2) slots, K running one tile
//     ahead of V.  Each slot has a full `mbarrier` for K and one for V
//     (Q K^T starts before V lands) and an empty one for each, which every
//     consumer warp arrives on when its products have read the tile: K
//     after Q K^T, V after P V, so the next K is in flight while V is
//     still read.  No other thread computes a copy address.  The tensor
//     maps are 4-D over (D, heads, S, B), so the copy zero-fills rows past
//     S of each row of the batch: no masking of the copy, and the ragged
//     edge costs nothing;
//   * tiles in shared memory are boxes of 64 columns under TMA's 128-byte
//     swizzle (D 64: 1 box a row, 128: 2, 192: 3, 256: 4).  D 96 is three
//     boxes of 32 columns under the 64-byte swizzle: the V tile is the B
//     operand of P V with N = D, and one `wgmma` descriptor spans its N
//     only over boxes of one width and one swizzle (its LBO is the one
//     stride between N-blocks), which 64 + 32 columns would not be;
//   * S = Q K^T: `wgmma.mma_async` m64nTKk16 with Q (A) and K (B) from
//     shared memory, both K-major, D / 16 k-steps; O += P V: m64nDk16 with
//     P as bf16 A fragments in registers, packed from the score
//     accumulators (the rounding the Pallas body does not do: within
//     2^-9 attn(|v|)), V as B from shared memory through the transpose
//     flag (MN-major);
//   * key tiles of TK = 64 rows at every D.  The online softmax then
//     blocks the keys as the earlier mma.sync kernel did at D 64, 96 and
//     128, and its outputs are that kernel's bit for bit: 128-key tiles
//     move a few roundings, which the MoE families' logprob checks (near
//     router ties) amplify past their limit, and gain little (`--phase
//     variants`, 128_key_tile).  A consumer thread keeps D / 2 f32 of O
//     (128 at D 256), TK / 2 of scores and TK / 4 of P.  `setmaxnreg`
//     moves the producer to 40 registers a thread and the consumers to
//     232, but ptxas (CUDA 12.9) fits every thread's code in the 168 the
//     launch bound leaves (128-key tiles at D 256 spill 328 bytes there);
//   * masks (causal, only on tiles that cross the diagonal or S; window;
//     segment ids) and softcap act on the score accumulators in registers;
//     the online softmax (max, sum, rescale) stays in f32, in the log2
//     domain with the scale folded into the exponent's FMA (`ex2.approx`);
//     a consumer skips the products of tiles all of whose keys its 64
//     rows cannot see (causal and window), and releases them once they
//     have landed, so that no consumer runs a round ahead of the other;
//   * inside a consumer, tile i's Q K^T is issued before tile i - 1's P V
//     and its masks and softmax run while the tensor cores do that P V
//     (O is rescaled to tile i - 1's max before its P V is issued).  The
//     warpgroup index goes through a shuffle, so that the compiler knows
//     the branches around each `wgmma` to be uniform and does not
//     serialise the products (ptxas C7518/C7514 otherwise).
// No persistent grid, no ping-pong between the consumers, no cluster
// multicast: one CTA an SM (168 registers a thread at launch), whose
// start (Q and the first K in flight) and end (the O stores) no other CTA
// hides.  `chip_smoke.py --phase variants` times a 3-slot ring, 1 against
// 2 consumers, 128-key tiles at D 128, and each product and the exponent
// removed in turn.
//
// f32 (the card's f32 end-to-end check, and the RL session's tiny LM at
// D = 32): `flash_f32_kernel`, f32 FMAs from shared memory (TF32 would not
// hold the f32 tolerance), 64 x 64 tiles.
//
// Both mask the ragged edge (S not a multiple of a tile, down to S = 1),
// where the TPU kernel asserted S % 128 == 0; a fully masked row gives 0,
// as both references do.

#include "hopper.cuh"

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


// -- bf16: TMA ring, wgmma ----------------------------------------------------

// consumer warpgroups a CTA (64 query rows each) and stages of the K/V ring
constexpr int kFlashConsumers = 2, kFlashStages = 2;
constexpr int kFlashThreads = 128 * (kFlashConsumers + 1);
// registers a thread after `setmaxnreg` (2 consumers): 128 x 40 + 256 x
// 232 = the SM's 65,536 (the CTA starts at 168 each); one CTA an SM
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct FlashTile {
  static constexpr int TQ = 64 * kFlashConsumers;   // query rows a CTA
  static constexpr int TK = 64;                     // keys a K/V tile
  static constexpr int BOXC = D == 96 ? 32 : 64;    // columns a TMA box
  static constexpr int NB = D / BOXC;               // boxes a tile row
  static constexpr int SWZ = 2 * BOXC;              // swizzle = box row bytes
  static constexpr int LAYOUT = BOXC == 64 ? kSwizzle128 : kSwizzle64;
  static constexpr uint32_t kQBox = TQ * SWZ, kKVBox = TK * SWZ;
  static constexpr uint32_t kQBytes = NB * kQBox, kKVBytes = NB * kKVBox;
  // 1 KB to align the tiles to the swizzle's repeat, then Q, the K ring,
  // the V ring and the barriers (Q full; K full, V full, K empty and V
  // empty a stage), for `stages` stages
  static constexpr size_t smem(int stages) {
    return 1024 + kQBytes + 2 * stages * kKVBytes + 8 * (1 + 4 * stages);
  }
  // stages of the ring: kFlashStages, or 2 where that many do not fit in
  // the 227 KB a CTA can have (D 256 at 3)
  static constexpr int ST = smem(kFlashStages) <= 232448 ? kFlashStages : 2;
  static constexpr size_t kSmem = smem(ST);
};

// Issues S = Q K^T for this warpgroup's 64 rows and the K tile of `kd`:
// D / 16 k-steps of m64nTKk16 from the swizzled boxes (a k-step is 32
// bytes into a box row), one commit group.
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[FlashTile<D>::TK / 2],
                                         uint64_t qd, uint64_t kd) {
  using T = FlashTile<D>;
  constexpr int KS = T::BOXC / 16;          // k-steps a box
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T::TK>(sc, qd + (((kk / KS) * T::kQBox + (kk % KS) * 32) >> 4),
                    kd + (((kk / KS) * T::kKVBox + (kk % KS) * 32) >> 4),
                    kk > 0);
  wgmma_commit();
}

// Issues O += P V: P (64 x TK) as bf16 A fragments, V (TK x D) of `vd`
// MN-major, 16 keys a k-step, one commit group.
template <int D>
__device__ __forceinline__ void pv_issue(
    float (&o)[D / 2], const uint32_t (&pa)[FlashTile<D>::TK / 16][4],
    uint64_t vd) {
  using T = FlashTile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::TK / 16; ++kk)
    wgmma_rs<D>(o, pa[kk], vd + ((kk * 16 * T::SWZ) >> 4), 1);
  wgmma_commit();
}

// Softcap, masks and the online softmax of one score tile, in registers.
// Element 4 j + e of `sc` is row r0 + 8 (e >> 1), key k0 + 8 j + 2 t +
// (e & 1) (the wgmma accumulator layout); the 4 threads of a quad share a
// row.  `sc` becomes P (f32), m and l move to this tile, and alpha is the
// factor that takes O from the last tile's max to this one's.  The max m
// is kept in the log2 domain: p = 2^(x * mul - m), x the raw score (mul =
// scale * log2 e) or, with softcap, the capped score already in the log2
// domain (mul = 1).
template <int TK>
__device__ __forceinline__ void softmax_tile(float (&sc)[TK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int row0, int r0, int t,
                                             int S, int window,
                                             const int* segb,
                                             const int (&segq)[2], float scale,
                                             float softcap, float mul) {
  if (softcap > 0.f) {
    const float cs = scale / softcap, cl = softcap * kLog2e;
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) sc[i] = tanhf(sc[i] * cs) * cl;
  }
  const bool full = k0 + TK - 1 <= row0 && k0 + TK <= S && window == 0 &&
                    segb == nullptr;               // warp-uniform
  if (!full) {
#pragma unroll
    for (int i = 0; i < TK / 2; ++i) {
      const int ks = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int qs = r0 + 8 * ((i >> 1) & 1);
      bool ok = ks <= qs && ks < S;
      if (window > 0) ok = ok && qs - ks < window;
      if (segb) ok = ok && ks < S && segb[ks] == segq[(i >> 1) & 1];
      if (!ok) sc[i] = -CUDART_INF_F;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
      mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * mul);
    const float ms = m_new == -CUDART_INF_F ? 0.f : m_new;
    alpha[r] = fast_exp2(m[r] - ms);   // 0 while m = -inf
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const int i = 4 * j + e;
        sc[i] = fast_exp2(fmaf(sc[i], mul, -ms));   // 0 if masked
        rsum += sc[i];
      }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
    l[r] = l[r] * alpha[r] + rsum;
    m[r] = m_new;
  }
}

// O (rows r0, r0 + 8) times each row's alpha.
template <int D>
__device__ __forceinline__ void rescale_o(float (&o)[D / 2],
                                          const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
}

// P (f32 score accumulators) to bf16 A fragments, 16 keys a k-step.
template <int TK>
__device__ __forceinline__ void p_fragments(uint32_t (&pa)[TK / 16][4],
                                            const float (&p)[TK / 2]) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = pack_bf16(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
}

template <int D>
__global__ void __launch_bounds__(kFlashThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const int* __restrict__ seg,
                   __nv_bfloat16* __restrict__ out, int S, int H, int Kh,
                   int window, float scale, float softcap) {
  using T = FlashTile<D>;
  constexpr int TQ = T::TQ, TK = T::TK, ST = T::ST;
  extern __shared__ unsigned char smem_fa[];
  const uint32_t sQ = (smem_u32(smem_fa) + 1023) & ~1023u;
  const uint32_t sK = sQ + T::kQBytes;             // [ST][NB][TK rows]
  const uint32_t sV = sK + ST * T::kKVBytes;       // [ST][NB][TK rows]
  const uint32_t q_full = sV + ST * T::kKVBytes;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * ST,  // + 8 slot
                 k_empty = v_full + 8 * ST, v_empty = k_empty + 8 * ST;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int kh = h / (H / Kh);
  const int q0 = qt * TQ;
  const int q_last = min(q0 + TQ, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / TK : 0;
  const int nt = q_last / TK - kt_lo + 1;          // causal block skip

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 4 * kFlashConsumers);   // one arrival a warp
      mbar_init(v_empty + 8 * s, 4 * kFlashConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // -- producer: one thread issues every copy ------------------------------
    if constexpr (kFlashConsumers == 2) setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::NB; ++c)
        tma_load_4d(sQ + c * T::kQBox, &tq, q_full, c * T::BOXC, h, q0, b);
      // K runs one tile ahead of V: K(it + 1) is in flight while the
      // consumers still hold V(it - 1); round 0 of each slot passes
      const auto load = [&](const CUtensorMap* map, uint32_t tiles,
                            uint32_t full, uint32_t empty, int it) {
        const int st = it % ST;
        mbar_wait(empty + 8 * st, ((it / ST) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::NB; ++c)
          tma_load_4d(tiles + st * T::kKVBytes + c * T::kKVBox, map,
                      full + 8 * st, c * T::BOXC, kh, (kt_lo + it) * TK, b);
      };
      load(&tk, sK, k_full, k_empty, 0);
      for (int it = 1; it < nt; ++it) {
        load(&tk, sK, k_full, k_empty, it);
        load(&tv, sV, v_full, v_empty, it - 1);
      }
      load(&tv, sV, v_full, v_empty, nt - 1);
    }
  } else {
    // -- consumers: 64 query rows a warpgroup ---------------------------------
    if constexpr (kFlashConsumers == 2) setmaxnreg_inc<kConsumerRegs>();
    // the warpgroup's index through a shuffle: the compiler then knows it
    // (and every branch around a wgmma) to be uniform across the
    // warpgroup, and does not serialise the products
    const int cw = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0) - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wr0 = q0 + 64 * cw;        // this warpgroup's first row
    const int row0 = wr0 + 16 * warp;    // this warp's first row
    const int r0 = row0 + g;             // this thread's rows: r0, r0 + 8
    const long long q_rs = (long long)H * D;
    const int* segb = seg ? seg + (long long)b * S : nullptr;
    int segq[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      segq[r] = segb && r0 + 8 * r < S ? segb[r0 + 8 * r] : 0;
    const float mul = softcap > 0.f ? 1.f : scale * kLog2e;
    float o[D / 2], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

    constexpr uint32_t kAtom = 8 * T::SWZ;   // bytes of 8 swizzled rows
    const uint64_t qd = wgmma_desc(sQ + 64 * cw * T::SWZ, 16, kAtom, T::LAYOUT);
    const uint64_t kd = wgmma_desc(sK, 16, kAtom, T::LAYOUT);
    const uint64_t vd = wgmma_desc(sV, T::kKVBox, kAtom, T::LAYOUT);
    // tile it's ring slot, and the parity of its round
    const auto slot = [](int it) { return it % ST; };
    const auto parity = [](int it) { return (uint32_t)((it / ST) & 1); };
    const auto release = [&](uint32_t empty, int it) {   // this warp is
      __syncwarp();                                      // done with it
      if (lane == 0) mbar_arrive(empty + 8 * slot(it));
    };
    // this warpgroup's tiles [lo, hi] of the CTA's nt: keys past its last
    // row or S, or older than its first row's window, are not visited.  A
    // tile outside is still seen to land before it is released: a
    // warpgroup that released tiles unseen could run a round ahead and
    // complete an empty barrier's phase for the other one.
    const int lo = window > 0 ? max(0, wr0 - window + 1) / TK - kt_lo : 0;
    const int hi = wr0 < S ? min(nt - 1, min(wr0 + 63, S - 1) / TK - kt_lo)
                           : -1;
    const auto pass = [&](int it) {
      mbar_wait(k_full + 8 * slot(it), parity(it));
      release(k_empty, it);
      mbar_wait(v_full + 8 * slot(it), parity(it));
      release(v_empty, it);
    };
    for (int it = 0; it < min(lo, nt); ++it) pass(it);
    mbar_wait(q_full, 0);

    float sc[TK / 2], alpha[2];
    uint32_t pa[TK / 16][4];
    if (lo <= hi) {
      {  // tile lo: its scores alone
        const int it = lo;
        mbar_wait(k_full + 8 * slot(it), parity(it));
        qk_issue<D>(sc, qd, kd + ((slot(it) * T::kKVBytes) >> 4));
        wgmma_wait<0>();
        fence_regs(sc);
        release(k_empty, it);
        softmax_tile<TK>(sc, m, l, alpha, (kt_lo + it) * TK, row0, r0, t, S,
                         window, segb, segq, scale, softcap, mul);
        p_fragments<TK>(pa, sc);
      }
      // tile it's scores are issued before tile it - 1's P V: the masks
      // and softmax of one tile run while the tensor cores do the other's
      // P V (O is taken to tile it - 1's max just before its P V)
      for (int it = lo + 1; it <= hi; ++it) {
        mbar_wait(k_full + 8 * slot(it), parity(it));
        qk_issue<D>(sc, qd, kd + ((slot(it) * T::kKVBytes) >> 4));
        rescale_o<D>(o, alpha);
        mbar_wait(v_full + 8 * slot(it - 1), parity(it - 1));
        pv_issue<D>(o, pa, vd + ((slot(it - 1) * T::kKVBytes) >> 4));
        wgmma_wait<1>();
        fence_regs(sc);
        release(k_empty, it);
        softmax_tile<TK>(sc, m, l, alpha, (kt_lo + it) * TK, row0, r0, t, S,
                         window, segb, segq, scale, softcap, mul);
        wgmma_wait<0>();
        fence_regs(o);
        release(v_empty, it - 1);
        p_fragments<TK>(pa, sc);
      }
      {  // tile hi: its P V alone
        const int it = hi + 1;
        rescale_o<D>(o, alpha);
        mbar_wait(v_full + 8 * slot(it - 1), parity(it - 1));
        pv_issue<D>(o, pa, vd + ((slot(it - 1) * T::kKVBytes) >> 4));
        wgmma_wait<0>();
        fence_regs(o);
        release(v_empty, it - 1);
      }
    }
    for (int it = max(hi + 1, lo); it < nt; ++it) pass(it);

    __nv_bfloat16* ob = out + (long long)b * S * q_rs + (long long)h * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= S) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = ob + row * q_rs + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                  o[4 * j + 2 * r + 1] * inv);
    }
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

// A 4-D map over a contiguous (B, S, heads, D) bf16 tensor, innermost
// first, cut in boxes of (BOXC columns, 1 head, `rows` rows, 1 row of the
// batch).  TMA needs the base and the strides 16-byte aligned (the wrapper
// checks the base; D * 2 bytes is a multiple of 16 at every D here).
template <int D>
bool encode_map(CUtensorMap* map, const void* base, int B, int S, int heads,
                int rows) {
  using T = FlashTile<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads,
                                 2ull * D * heads * S};
  const cuuint32_t box[4] = {(cuuint32_t)T::BOXC, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                T::BOXC == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* seg,
                void* out, int B, int S, int H, int Kh, int window,
                float softcap, cudaStream_t stream) {
  using T = FlashTile<D>;
  static bool configured = false;
  if (int e = set_smem(flash_wgmma_kernel<D>, T::kSmem, configured)) return e;
  CUtensorMap tq, tk, tv;
  if (!encode_map<D>(&tq, q, B, S, H, T::TQ) ||
      !encode_map<D>(&tk, k, B, S, Kh, T::TK) ||
      !encode_map<D>(&tv, v, B, S, Kh, T::TK))
    return (int)cudaErrorInvalidValue;
  const int nq = (S + T::TQ - 1) / T::TQ;
  flash_wgmma_kernel<D><<<dim3(H, B, nq), kFlashThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<const int*>(seg),
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
