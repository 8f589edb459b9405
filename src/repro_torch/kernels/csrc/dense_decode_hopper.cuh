// Dense GQA decode attention for Hopper (sm_90a): bf16 q over a bf16
// (B, S, Kh, D) cache, one launch a call.
//
// Replaces, for bf16 q, the Pallas TPU kernel `ragged_decode_attention` of
// src/repro/kernels/ragged_decode_attention.py:137 (`_kernel` +
// `_flash_decode_block`, :42).  f32 q keeps the split-KV body of
// decode_attention.cuh.
//
// What bounds it on the H100: bytes.  Every live K and V row is read once,
// and a row of D elements costs 4 G D flops, far below the ~295 flop/byte
// where the tensor cores would become the limit.  The split-KV body it
// replaces lost its time around the bytes: a grid of (KV head, slot, 256-row
// split) CTAs (8,200 short-lived ones over long_500k's 524,800 rows), all
// of a split's K scored before its V streamed (the ring drained between),
// a second launch whose (head, slot) CTAs walked every split serially, and
// two f32 scratch tensors allocated per call.  The design:
//   * a balanced persistent grid, planned on the device: SMs x (CTAs an SM
//     holds), one CTA an SM in practice (the rings take ~200 KB).  A unit
//     is one chunk of R contiguous live rows (R 16 or 32, `dd_rows`) of a
//     group of KG KV heads of one slot (KG = the most KV heads, up to the
//     CTA's warps, that divide Kh: a row's KG heads are one run of KG x D
//     elements).  A slot's live rows are [kv_start, min(kv_len, S)), so
//     any S works and kv_start >= kv_len gives no unit (zeros).  Every CTA
//     reads kv_len and kv_start (B ints each), orders the units by slot,
//     then KV head group, then chunk, and takes the equal contiguous range
//     [c U / C, (c + 1) U / C).  The host never reads either.  long_500k's
//     one slot spreads over every CTA; the serve shape's slots are dealt
//     out evenly;
//   * one warp a KV head of the group (8 warps, 4 at D >= 192 or G > 8),
//     no producer warp: each warp streams its KV head's rows of each unit
//     into a ring of its own, kDdMaxStages units deep, K and V of a unit
//     in one stage.  At every D that is a multiple of 64 lane 0 copies a
//     unit's rows by TMA: 64-column boxes of a 4-D tensor map over the
//     (B, S, Kh, D) cache (a slot's rows are one run, so no table is
//     read), completion on the stage's `mbarrier`, under the 128-byte
//     swizzle, which keeps `ldmatrix` free of bank conflicts.  Rows past S
//     are zero-filled by the copy; rows past the slot's live rows but below
//     S are copied, so the warp zeroes their V rows before the products
//     (their scores are masked out of the softmax).  TMA beat `cp.async`
//     by 1.7-4.4% at long_500k, decode_32k, the serve shape and Gemma2's
//     ring (`chip_smoke.py --phase variants`, `ragged_decode/cp_async`),
//     where PR 25 had found it no faster on 16-row pages.  At D 96 each
//     lane copies 16 bytes at a time with `cp.async`, rows padded by 16
//     bytes in shared memory, rows past the live ones zero-filled (never
//     read).  The warps never wait for each other in the loop;
//   * an online softmax over each 16-row piece of a chunk, K and V of it
//     in flight together (no score buffer, no drain between K and V), in
//     the log2 domain; a piece that moves no row's max skips the
//     accumulators' rescale;
//   * both products on tensor cores, `mma.sync.m16n8k16` bf16 -> f32, with
//     the layouts of the paged kernel (paged_decode_hopper.cuh): the heads
//     are M and 16 keys N of S = Q K^T, P is then the A operand of O += P V
//     with no shuffle; at D 256 O^T = V^T P^T (a thread keeps D / 4
//     accumulators).  q enters unscaled, 1/sqrt(D) and the softcap act on
//     the f32 score, the weights enter P V as three bf16 terms, hi + mid +
//     lo: 24 bits, the f32 weights of the body before.  (Two terms, the
//     paged kernel's 16 bits, moved ~0.2% of the bf16 outputs by a step
//     against the body, which changed Zamba2-1.2B's greedy streams in the
//     `families` phase; the third costs one more product a column group);
//   * the merge inside the kernel: a piece (a unit range's part of an
//     item, an item being a slot's KV head group) that is a whole item
//     writes its output; a split one writes f32 (max, sum, accumulator) for
//     its KV heads' G heads into the CTA's workspace slot (2 c for the
//     piece its range opens with, 2 c + 1 for the one it ends with, as in
//     the paged kernel) when it ends.  At the range's end the CTA fences
//     and counts itself on the arrive counter of each of its (at most two)
//     split items.  An item of a few pieces is merged by the CTA that
//     completes its count, a thread a column; an item of kDdSpreadPieces
//     or more (long_500k's ~132) by every CTA that holds a piece of it,
//     each a slice of the columns once all have arrived, 32 lanes a column
//     combined by shuffles.  Both take the weights of
//     `ref.merge_split_partials_ref` in a fixed order.  One CTA merging 132
//     pieces ran 58 us past the last ring at long_500k; every CTA waiting
//     for its items' other pieces made the serve shape's tail 29 us, where
//     the completing CTA's is 7 (`tools/dense_decode_trace.py`).  The
//     waits need every CTA resident: the kernel is launched
//     cooperatively, its grid what the SMs hold.  No second launch, no
//     per-call allocation: the wrapper keeps the workspace (2 C slots;
//     arrive and depart counters, B Kh each, zeroed once, set back to 0 by
//     each item's last CTA) per device and stream, so the kernel can be
//     captured in a graph.  A slot with no live row gets zeros.
// `chip_smoke.py --phase variants` edits kDdRows, kDdMaxStages, kDdWarps,
// kDdRing, the copies and the D 256 layout to time the design's choices,
// and times the split-KV body beside it (`ragged_decode/split_body`).
#pragma once

#include "paged_decode_hopper.cuh"

namespace rt {

constexpr int kDdWarps = 8;             // warps = most KV heads a unit
constexpr int kDdWideWarps = 4;         // (at D >= 192 or G > 8)
constexpr int kDdRing = 212992;         // bytes of the warps' rings and q
constexpr int kDdRows = 32;             // most rows of a unit (16 x n)
constexpr int kDdMaxStages = 2;         // units in a warp's ring
constexpr int kDdMergeBatch = 8;        // pieces a merging lane loads at once
// pieces from which every CTA holding one merges a slice of the item (below
// it the CTA that completes the item merges all of it)
constexpr int kDdSpreadPieces = 33;
// ln 2: an lse in log2 units (the running maxima's) to natural log
constexpr float kDdLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int dd_warps(int D, int G) {
  return D >= 192 || G > 8 ? kDdWideWarps : kDdWarps;
}

// Rows of a unit: the most, a multiple of 16 up to kDdRows, of which two
// units (K and V, padded rows) fit a warp's share of the ring.
__host__ __device__ constexpr int dd_rows(int per_warp, int pitch) {
  int r = kDdRows;
  while (r > 16 && 2 * 2 * r * pitch > per_warp) r -= 16;
  return r;
}

template <int D, int G>
struct DdShape {
  static constexpr int kWarps = dd_warps(D, G);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kChunks = kRowBytes / 16;        // 16-byte copies
  // TMA copies (64-column boxes, swizzled) at D % 64 == 0, else cp.async
  // into rows padded by 16 bytes: 8 rows of one 16-byte column chunk then
  // lie in 8 bank groups
  static constexpr bool kTma = D % 64 == 0;
  static constexpr int kPitch = kTma ? kRowBytes : kRowBytes + 16;
  // O^T = V^T P^T at D 256 (G <= 8): D as M in 16-row tiles, the heads as
  // N, so a thread keeps D / 4 accumulators instead of D / 2
  static constexpr bool kT = D >= 256 && G <= 8;
  // q's fragments in shared memory (a copy per warp) rather than in
  // registers at D >= 192, where O takes 64-96 accumulators a thread (in
  // registers at D 256 it left none to spare: 255, and the same speed)
  static constexpr bool kQSmem = D >= 192;
  static constexpr int kMTiles = D / 16;
  static constexpr int kQBytes = kQSmem ? kWarps * (D / 16) * 32 * 16 : 0;
  static constexpr int kPerWarp = (kDdRing - kQBytes) / kWarps;
  static constexpr int kRows = dd_rows(kPerWarp, kPitch);
  static constexpr int kTile = kRows * kPitch;          // K or V of a unit
  static constexpr int kStageBytes = 2 * kTile;         // K, then V
  static constexpr int kStagesRaw = kPerWarp / kStageBytes;
  static constexpr int kStages = kStagesRaw > kDdMaxStages ? kDdMaxStages
                                                           : kStagesRaw;
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static constexpr int kGroups = kRowBytes / 32;        // ldmatrix.x4 a piece
  static constexpr int kKSteps = D / 16;
  static constexpr int kNTiles = D / 8;
  static constexpr bool kHi = G > 8;                    // rows 8..15 live
  // 1024 bytes to align the rings (the swizzle repeats every 1024), the
  // rings, the plan and the CTA's pending merges (128 bytes), an mbarrier
  // for each of up to 4 stages of each warp, q
  static constexpr int kSmem = 1024 + kRingBytes + 128 + 8 * kWarps * 4
                               + kQBytes;
  static_assert(kRowBytes % 32 == 0 && G <= 16 && D % 16 == 0 &&
                kRows % 16 == 0 && kRows * kChunks % 32 == 0 &&
                kStages >= 2 && kSmem <= 232448,
                "dense decode shape");
};

// Where the kernel reads and writes.
struct DdParams {
  const __nv_bfloat16* q;       // (B, H, D)
  const char* k;                // (B, S, Kh, D)
  const char* v;
  const int* kv_len;            // (B,)
  const int* kv_start;          // (B,) first live row, or null for 0
  __nv_bfloat16* out;           // (B, H, D)
  float* lse;                   // (B, H) f32 log-sum-exp, or null
  float* ws;                    // 2 C slots x kg x G x (2 + D) f32
  int* counters;                // (B, Kh), 0 between launches
  int B, H, S, Kh, kg;          // kg: KV heads a unit, pd_group(Kh, W)
  float scale, softcap;
};

// p as three bf16 terms of one fragment register triple, hi + mid + lo:
// 24 significant bits, the f32 weight itself (two terms keep 16)
__device__ __forceinline__ void split3_bf16(float a, float b, uint32_t& hi,
                                            uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(a, b);
  const float ra = a - bf_lo(hi), rb = b - bf_hi(hi);
  mid = pack_bf16(ra, rb);
  lo = pack_bf16(ra - bf_lo(mid), rb - bf_hi(mid));
}

// An int in global memory read with acquire order at GPU scope (a
// counter other CTAs release to).
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// atomicAdd with acquire and release order at GPU scope: after a CTA
// barrier, the CTA's writes before it are visible to whoever reads the
// count (the barrier and the release are cumulative, so no thread but the
// counting one fences), and the CTA that completes a count sees every
// writer's partials.
__device__ __forceinline__ int add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// A split item of the CTA's range, counted and merged at its end.
struct DdItem {
  long long item0;              // the item's first unit
  int b, kg, nc;                // slot, KV head group, chunks
  int last;                     // this CTA completed its arrive count
};

template <int D, int G>
__global__ void __launch_bounds__(DdShape<D, G>::kThreads, 1)
dense_decode_hopper_kernel(const DdParams p,
                           const __grid_constant__ CUtensorMap km,
                           const __grid_constant__ CUtensorMap vm) {
  using S = DdShape<D, G>;
  constexpr int ST = S::kStages, NT = S::kThreads, R = S::kRows;
  const float kInf = CUDART_INF_F;
  extern __shared__ unsigned char rt_dd_smem[];
  const uint32_t raw = smem_u32(rt_dd_smem);
  const uint32_t rings = (raw + 1023) & ~1023u;
  unsigned char* grings = rt_dd_smem + (rings - raw);
  long long* plan = reinterpret_cast<long long*>(grings + S::kRingBytes);
  DdItem* pend = reinterpret_cast<DdItem*>(plan + 4);   // 2 x 24 bytes
  int* npend = reinterpret_cast<int*>(plan + 10);
  const uint32_t bars = smem_u32(plan + 16);   // an mbarrier a stage
  uint4* qsm = reinterpret_cast<uint4*>(plan + 16 + S::kWarps * 4);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = p.B, Kh = p.Kh, KG = p.kg, NG = Kh / KG;
  const auto start_of = [&](int b) {
    return p.kv_start == nullptr ? 0 : max(__ldg(p.kv_start + b), 0);
  };
  const auto len_of = [&](int b) {
    return max(min(__ldg(p.kv_len + b), p.S) - start_of(b), 0);
  };
  const auto units_of = [&](int b) { return (len_of(b) + R - 1) / R; };

  // slots with no live row get zeros and an lse of -inf (no unit
  // reaches them)
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    if (len_of(b) == 0) {
      __nv_bfloat16* o = p.out + (long long)b * p.H * D;
      for (int i = tid; i < p.H * D; i += NT) o[i] = __float2bfloat16(0.f);
      if (p.lse != nullptr)
        for (int i = tid; i < p.H; i += NT) p.lse[(long long)b * p.H + i] = -kInf;
    }
  }

  // -- the plan: U units, this CTA's range [u0, u1)
  if (warp == 0) {
    long long tot = 0;
    for (int b = lane; b < B; b += 32) tot += units_of(b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    const long long U = tot * NG;
    const long long ce = min((long long)gridDim.x, U);
    if (lane == 0) {
      plan[0] = U;
      plan[1] = ce;
      plan[2] = blockIdx.x < ce ? blockIdx.x * U / ce : 0;
      plan[3] = blockIdx.x < ce ? (blockIdx.x + 1) * U / ce : 0;
      *npend = 0;
    }
  }
  __syncthreads();
  const long long U = plan[0], ce = plan[1], u0 = plan[2], n = plan[3] - u0;

  // -- the walk over (slot, KV head group, chunk)
  struct Walk {
    int b, kg, ch, nc, len;
    long long row0;                           // the slot's first live row
    long long item0;                          // the item's first unit
  };
  const auto enter = [&](Walk& w) {           // w.b set: its rows
    w.len = w.b < B ? len_of(w.b) : 0;
    w.nc = w.b < B ? (w.len + R - 1) / R : 1 << 30;
    w.row0 = w.b < B ? (long long)w.b * p.S + start_of(w.b) : 0;
  };
  const auto next_slot = [&](int b) {
    do { ++b; } while (b < B && len_of(b) == 0);
    return b;
  };
  // w moved on by r units (r >= 0); past the last slot nc is huge
  const auto skip = [&](Walk& w, int r) {
    r += w.ch;
    while (r >= w.nc) {
      r -= w.nc;
      w.item0 += w.nc;
      if (++w.kg == NG) {
        w.kg = 0;
        w.b = next_slot(w.b);
        enter(w);
      }
    }
    w.ch = r;
  };
  // the walk at unit u < U (the whole warp): the slot b with NG pre(b) <=
  // u < NG pre(b + 1), pre(b) the chunks of the slots before b
  const auto locate = [&](long long u) {
    Walk w{};
    long long pre = 0;
    for (int base = 0; base < B; base += 32) {
      const int b = base + lane;
      const long long x = b < B ? units_of(b) : 0;
      long long inc = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
      }
      const long long exc = pre + inc - x;
      const unsigned hit = __ballot_sync(
          0xffffffffu, x > 0 && NG * exc <= u && u < NG * (exc + x));
      if (hit != 0u) {
        const int src = __ffs(hit) - 1;
        const long long c0 = __shfl_sync(0xffffffffu, exc, src);
        w.b = base + src;
        enter(w);
        const long long rem = u - NG * c0;
        w.kg = (int)(rem / w.nc);
        w.ch = (int)(rem % w.nc);
        w.item0 = NG * c0 + (long long)w.kg * w.nc;
        break;
      }
      pre += __shfl_sync(0xffffffffu, inc, 31);
    }
    return w;
  };
  // -- warp cw takes KV head kg KG + cw of every unit of the CTA's range
  const int cw = warp;
  const bool active = cw < KG;
  const int g = lane >> 2, t = lane & 3;
  const PdLanes<S::kPitch> lanes(lane);
  // this warp's ring: its j-th unit in stage j % ST, K then V
  const uint32_t ring = rings + cw * ST * S::kStageBytes;
  float* wml = p.ws;                                   // (2 C, KG, G, 2)
  float* wacc = p.ws + 2LL * gridDim.x * KG * G * 2;   // (2 C, KG, G, D)
  const auto cta_of = [&](long long u) { return ((u + 1) * ce - 1) / U; };
  // the pieces of an item in CTA order: piece j > 0 (CTA cf + j, whose
  // range starts inside the item) sits in slot 2 (cf + j), piece 0 in
  // 2 cf, or in 2 cf + 1 where the item starts inside CTA cf's range
  const auto pieces = [&](long long item0, int nc, long long& cf,
                          long long& slot0) {
    cf = cta_of(item0);
    slot0 = 2 * cf + (cf * U / ce >= item0 ? 0 : 1);
    return (int)(cta_of(item0 + nc - 1) - cf + 1);
  };

  // the copies of unit u's rows of this warp's KV head (the unit at walk
  // iw, which moves on by one): TMA, the boxes of K and V announced on the
  // stage's mbarrier by lane 0 (after a proxy fence: the stage was last
  // read and written by the threads); or (D 96) 16 bytes a lane at a time,
  // one cp.async group a unit (an empty one past the range), rows past the
  // slot's live rows zero-filled, nothing read
  const long long rowb = (long long)Kh * S::kRowBytes;
  const auto issue = [&](long long u, Walk& iw) {
    if constexpr (S::kTma) {
      if (u < n) {
        const int s = (int)(u % ST);
        const uint32_t bar = bars + 8 * (cw * ST + s);
        const uint32_t dst = ring + s * S::kStageBytes;
        const int t = (int)(iw.row0 - (long long)iw.b * p.S) + R * iw.ch;
        const int kh = iw.kg * KG + cw;
        if (lane == 0) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_expect_tx(bar, 2 * R * S::kRowBytes);
#pragma unroll
          for (int j = 0; j < D / 64; ++j) {
            tma_load_4d(dst + j * R * 128, &km, bar, 64 * j, kh, t, iw.b);
            tma_load_4d(dst + S::kTile + j * R * 128, &vm, bar, 64 * j, kh, t,
                        iw.b);
          }
        }
        skip(iw, 1);
      }
      return;
    }
    if (u < n) {
      const int s = (int)(u % ST);
      const int nr = min(R, iw.len - R * iw.ch);
      const long long off = (iw.row0 + (long long)R * iw.ch) * rowb
                            + (long long)(iw.kg * KG + cw) * S::kRowBytes;
      const char* ks = p.k + off;
      const char* vs = p.v + off;
      const uint32_t dst = ring + s * S::kStageBytes;
#pragma unroll
      for (int c0 = 0; c0 < R * S::kChunks; c0 += 32) {
        const int c = c0 + lane;
        const int r = c / S::kChunks, ch = c - r * S::kChunks;
        const bool live = r < nr;
        const long long so = (live ? r * rowb : 0) + ch * 16;
        cp_async16(dst + r * S::kPitch + ch * 16, ks + so, live ? 16 : 0);
        cp_async16(dst + S::kTile + r * S::kPitch + ch * 16, vs + so,
                   live ? 16 : 0);
      }
      skip(iw, 1);
    }
    cp_async_commit();
  };

  // q of the KV head's G heads as A fragments (rows g and g + 8), in
  // registers, or (kQSmem) in this warp's part of qsm
  uint32_t qa[S::kQSmem ? 1 : S::kKSteps][4];
  uint4* qmine = qsm + cw * S::kKSteps * 32 + lane;
  const auto qfrag = [&](int j, uint32_t (&a)[4]) {
    if constexpr (S::kQSmem) {
      const uint4 v = qmine[j * 32];
      a[0] = v.x;
      a[1] = v.y;
      a[2] = v.z;
      a[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qa[j][i];
    }
  };
  const auto load_q = [&](const Walk& w) {
    const int kh = w.kg * KG + cw;
    const __nv_bfloat16* qb = p.q + ((long long)w.b * p.H + kh * G) * D;
#pragma unroll
    for (int j = 0; j < S::kKSteps; ++j) {
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = g + 8 * r;
        uint32_t x0 = 0u, x1 = 0u;
        if (h < G) {
          x0 = *reinterpret_cast<const uint32_t*>(qb + h * D + 16 * j + 2 * t);
          x1 = *reinterpret_cast<const uint32_t*>(qb + h * D + 16 * j + 2 * t + 8);
        }
        a[r] = x0;             // a0 (row g) / a1 (row g + 8)
        a[2 + r] = x1;         // a2 / a3
      }
      if constexpr (S::kQSmem) {
        qmine[j * 32] = make_uint4(a[0], a[1], a[2], a[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[j][i] = a[i];
      }
    }
  };

  // O: tiles of (heads, 8 columns), or (kT) of (16 columns, heads)
  float o[S::kT ? S::kMTiles : S::kNTiles][4], m[2], l[2];
  const auto reset = [&]() {
#pragma unroll
    for (int nt = 0; nt < (S::kT ? S::kMTiles : S::kNTiles); ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
    m[0] = m[1] = -kInf;
    l[0] = l[1] = 0.f;
  };
  const auto score = [&](float v) {
    v *= p.scale;
    if (p.softcap > 0.f) v = tanhf(v / p.softcap) * p.softcap;
    return v * kPdLog2e;
  };
  // online softmax step of row r (head g + 8 r) with new max candidate mx
  // (already reduced over the quad); returns the reference the weights
  // are taken against (most pieces leave every row's max where it was:
  // the warp then skips the accumulators' multiply)
  const auto rescale = [&](int r, float mx) {
    const float mn = fmaxf(m[r], mx);
    const float ref = mn == -kInf ? 0.f : mn;
    const float alpha = fast_exp2(m[r] - ref);
    m[r] = mn;
    l[r] *= alpha;
    if (__any_sync(0xffffffffu, alpha != 1.f)) {
      if constexpr (S::kT) {
        // this lane's O^T columns are heads 2t and 2t + 1, whose softmax
        // rows lanes 8t and 8t + 4 keep
        const float a0 = __shfl_sync(0xffffffffu, alpha, 8 * t);
        const float a1 = __shfl_sync(0xffffffffu, alpha, 8 * t + 4);
#pragma unroll
        for (int mt = 0; mt < S::kMTiles; ++mt) {
          o[mt][0] *= a0;
          o[mt][1] *= a1;
          o[mt][2] *= a0;
          o[mt][3] *= a1;
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < S::kNTiles; ++nt) {
          o[nt][2 * r] *= alpha;
          o[nt][2 * r + 1] *= alpha;
        }
      }
    }
    return ref;
  };

  // 16 rows of this warp's KV head (K at kst, V at vst); `lim` of them live
  // the address this lane hands ldmatrix for 32-byte column group cg of
  // piece i (16 rows) of a K or V tile: under the 128-byte swizzle row rr's
  // 16-byte chunk j lies in box j / 8 at chunk (j % 8) ^ (rr % 8)
  const auto at = [&](uint32_t tile, int i, int cg) {
    if constexpr (S::kTma) {
      const int rr = 16 * i + (lane & 15), j = 2 * cg + (lane >> 4);
      return tile + (j >> 3) * R * 128 + rr * 128
             + (((j & 7) ^ (rr & 7)) << 4);
    } else {
      return tile + 16 * i * S::kPitch + lanes.at(cg);
    }
  };
  const auto piece16 = [&](uint32_t kst, uint32_t vst, int i, int lim) {
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int cg = 0; cg < S::kGroups; ++cg) {
      // r0/r1: keys 0-7 / 8-15 of columns 16 cg..+7, r2/r3 of +8..+15
      uint32_t r[4], a[4];
      ldmatrix_x4(r, at(kst, i, cg));
      qfrag(cg, a);
      mma_bf16(sa, a, r[0], r[2]);
      mma_bf16(sb, a, r[1], r[3]);
    }
    float x[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 2 * t + (e & 1);
      x[0][e] = key < lim ? score(sa[e]) : -kInf;
      x[1][e] = key + 8 < lim ? score(sb[e]) : -kInf;
    }
    float pw[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int r = 0; r < (S::kHi ? 2 : 1); ++r) {
      float mx = fmaxf(fmaxf(x[0][2 * r], x[0][2 * r + 1]),
                       fmaxf(x[1][2 * r], x[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float ref = rescale(r, mx);
      float ps = 0.f;
#pragma unroll
      for (int tt = 0; tt < 2; ++tt)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          pw[tt][e] = fast_exp2(x[tt][e] - ref);
          ps += pw[tt][e];
        }
      l[r] += ps;
    }
    uint32_t ah[4], am[4], al[4];
    split3_bf16(pw[0][0], pw[0][1], ah[0], am[0], al[0]);   // row g, keys 2t..
    split3_bf16(pw[1][0], pw[1][1], ah[2], am[2], al[2]);   // keys 8+2t..
    split3_bf16(pw[0][2], pw[0][3], ah[1], am[1], al[1]);   // row g + 8
    split3_bf16(pw[1][2], pw[1][3], ah[3], am[3], al[3]);
#pragma unroll
    for (int cg = 0; cg < S::kGroups; ++cg) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, at(vst, i, cg));
      if constexpr (S::kT) {
        // V^T rows 16 cg..+15 as A: r0/r2 keys 0-7 of columns +0..7 /
        // +8..15, r1/r3 keys 8-15; P^T as B: P's rows g, keys 2t.. and 8+2t..
        const uint32_t a[4] = {r[0], r[2], r[1], r[3]};
        mma_bf16(o[cg], a, ah[0], ah[2]);
        mma_bf16(o[cg], a, am[0], am[2]);
        mma_bf16(o[cg], a, al[0], al[2]);
      } else {
        mma_bf16(o[2 * cg], ah, r[0], r[1]);
        mma_bf16(o[2 * cg], am, r[0], r[1]);
        mma_bf16(o[2 * cg], al, r[0], r[1]);
        mma_bf16(o[2 * cg + 1], ah, r[2], r[3]);
        mma_bf16(o[2 * cg + 1], am, r[2], r[3]);
        mma_bf16(o[2 * cg + 1], al, r[2], r[3]);
      }
    }
  };
  // a unit in ring stage s: its 16-row pieces with a live row
  const auto unit = [&](int s, int lim) {
    const uint32_t kst = ring + s * S::kStageBytes;
#pragma unroll
    for (int i = 0; i < R / 16; ++i)
      if (16 * i < lim)
        piece16(kst, kst + S::kTile, i, lim - 16 * i);
  };

  // (kT) f(head, column, v) over this lane's O^T elements: tile mt's c0..c3
  // at (column 16 mt + g (+ 8 for c2, c3), head 2t (+ 1 for c1, c3))
  const auto elems = [&](auto&& f) {
#pragma unroll
    for (int mt = 0; mt < S::kMTiles; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 2 * t + (e & 1);
        if (h < G) f(h, 16 * mt + g + 8 * (e >> 1), o[mt][e]);
      }
  };
  // f(head, column, v0, v1) over this lane's accumulator pairs (tile nt,
  // columns 8 nt + 2 t and the next)
  const auto pairs = [&](auto&& f) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = g + 8 * r;
      if (h >= G || (r == 1 && !S::kHi)) continue;
#pragma unroll
      for (int nt = 0; nt < S::kNTiles; ++nt)
        f(h, 8 * nt + 2 * t, o[nt][2 * r], o[nt][2 * r + 1]);
    }
  };
  // the sums over the quad, at a piece's end
  const auto sums = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
  };
  // a whole item's output: this warp's KV head's G heads
  const auto write_out = [&](const Walk& w) {
    const int kh = w.kg * KG + cw;
    __nv_bfloat16* out = p.out + ((long long)w.b * p.H + kh * G) * D;
    if constexpr (S::kT) {
      // the sums of this lane's O^T heads 2t and 2t + 1
      const float lt[2] = {__shfl_sync(0xffffffffu, l[0], 8 * t),
                           __shfl_sync(0xffffffffu, l[0], 8 * t + 4)};
      elems([&](int h, int col, float v) {
        out[h * D + col] = __float2bfloat16(v / fmaxf(lt[h & 1], 1e-30f));
      });
    } else {
      const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
      pairs([&](int h, int col, float v0, float v1) {
        const float iv = inv[h >= 8];
        *reinterpret_cast<__nv_bfloat162*>(out + h * D + col) =
            __floats2bfloat162_rn(v0 * iv, v1 * iv);
      });
    }
    // the lse of head g + 8 r, natural log: its max is in log2 units
    if (p.lse != nullptr && t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = g + 8 * r;
        if (h < G && (r == 0 || S::kHi))
          p.lse[(long long)w.b * p.H + kh * G + h] =
              (m[r] + log2f(l[r])) * kDdLn2;
      }
    }
  };
  // a piece that ends: a whole item writes its output; a split one its
  // partial, (max, sum) of its G heads and the f32 accumulators (G x D),
  // into its workspace slot (slot0 for the item's first CTA, else the
  // CTA's first slot), and warp 0 books the item for the count
  const auto finish = [&](const Walk& w) {
    sums();
    long long cf, slot0;
    if (pieces(w.item0, w.nc, cf, slot0) == 1) {
      write_out(w);
      return;
    }
    const long long slot = blockIdx.x == cf ? slot0 : 2LL * blockIdx.x;
    const long long base = (slot * KG + cw) * G;
    float* ml = wml + base * 2;
    float* acc = wacc + base * D;
    if constexpr (S::kT) {
      elems([&](int h, int col, float v) { acc[h * D + col] = v; });
    } else {
      pairs([&](int h, int col, float v0, float v1) {
        *reinterpret_cast<float2*>(acc + h * D + col) = make_float2(v0, v1);
      });
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = g + 8 * r;
        if (h < G && (r == 0 || S::kHi)) {
          ml[2 * h] = m[r];
          ml[2 * h + 1] = l[r];
        }
      }
    }
    if (cw == 0 && lane == 0) pend[(*npend)++] = DdItem{w.item0, w.b, w.kg, w.nc, 0};
  };

  // (m, l, A) of pieces merged into (M, L, C): the weights exp(m - M')
  // of merge_split_partials_ref against the larger max M'; a side with no
  // piece (max -inf) weighs 0
  const auto combine = [&](float& M, float& L, float4& C, float m, float l,
                           float4 A) {
    const float mn = fmaxf(M, m);
    if (mn == -kInf) return;
    const float a = fast_exp2(M - mn), b = fast_exp2(m - mn);
    L = fmaf(L, a, l * b);
    C = make_float4(fmaf(C.x, a, A.x * b), fmaf(C.y, a, A.y * b),
                    fmaf(C.z, a, A.z * b), fmaf(C.w, a, A.w * b));
    M = mn;
  };
  // float4 columns [c0, c1) of the merge of a split item's npc pieces (of
  // its KG x G x D outputs), P lanes a column (P 1 or 32): lane ps of a
  // column merges pieces ps, ps + P, ... in order (kDdMergeBatch loads in
  // flight), then the P lanes combine by xor shuffles, 1 apart first.  The
  // assignment and the order are fixed, so the result does not depend on
  // which CTA ends first
  constexpr int kC4 = G * D / 4;                 // float4 columns a head
  const auto merge = [&](const DdItem& it, int c0, int c1, int P) {
    constexpr int kJ = kDdMergeBatch;
    long long cf, slot0;
    const int npc = pieces(it.item0, it.nc, cf, slot0);
    const int ps = lane & (P - 1), per = 32 / P;       // columns a warp
    __nv_bfloat16* out = p.out + ((long long)it.b * Kh + it.kg * KG) * G * D;
    for (int base = c0 + warp * per; base < c1; base += S::kWarps * per) {
      const int c = base + lane / P;
      const int kk = c / kC4, e = 4 * (c - kk * kC4);
      const int h = e / D, d = e - h * D;
      float M = -kInf, L = 0.f;
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j0 = ps; j0 < npc && c < c1; j0 += kJ * P) {
        float mj[kJ], lj[kJ];
        float4 aj[kJ];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int j = j0 + jj * P;
          mj[jj] = -kInf;
          if (j < npc) {
            const long long sl = j == 0 ? slot0 : 2 * (cf + j);
            const long long bs = (sl * KG + kk) * G + h;
            mj[jj] = __ldcg(wml + bs * 2);
            lj[jj] = __ldcg(wml + bs * 2 + 1);
            aj[jj] = __ldcg(reinterpret_cast<const float4*>(wacc + bs * D + d));
          }
        }
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
          if (mj[jj] != -kInf) combine(M, L, A, mj[jj], lj[jj], aj[jj]);
      }
      for (int o = 1; o < P; o <<= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, M, o);
        const float l2 = __shfl_xor_sync(0xffffffffu, L, o);
        float4 a2;
        a2.x = __shfl_xor_sync(0xffffffffu, A.x, o);
        a2.y = __shfl_xor_sync(0xffffffffu, A.y, o);
        a2.z = __shfl_xor_sync(0xffffffffu, A.z, o);
        a2.w = __shfl_xor_sync(0xffffffffu, A.w, o);
        // the lower lane's pieces first, so both lanes hold one result
        if (ps & o) {
          float m1 = m2, l1 = l2;
          float4 a1 = a2;
          combine(m1, l1, a1, M, L, A);
          M = m1;
          L = l1;
          A = a1;
        } else {
          combine(M, L, A, m2, l2, a2);
        }
      }
      if (ps == 0 && c < c1) {
        const float inv = 1.f / fmaxf(L, 1e-30f);
        *reinterpret_cast<uint2*>(out + (kk * G + h) * D + d) =
            make_uint2(pack_bf16(A.x * inv, A.y * inv),
                       pack_bf16(A.z * inv, A.w * inv));
        // a head's lse from the lane of its first columns
        if (p.lse != nullptr && d == 0)
          p.lse[((long long)it.b * Kh + it.kg * KG + kk) * G + h] =
              (M + log2f(L)) * kDdLn2;
      }
    }
  };

  if (active && n > 0) {
    Walk w = locate(u0);
    Walk iw = w;                                 // the copy side's walk
    if constexpr (S::kTma) {
      if (lane == 0) {
        for (int s = 0; s < ST; ++s) mbar_init(bars + 8 * (cw * ST + s), 1);
        mbar_fence_init();
      }
      __syncwarp();
    }
#pragma unroll
    for (int u = 0; u < ST; ++u) issue(u, iw);
    load_q(w);
    reset();
    for (long long k = 0;; ++k) {
      const int s = (int)(k % ST);
      const int lim = w.len - R * w.ch;
      if constexpr (S::kTma) {
        mbar_wait(bars + 8 * (cw * ST + s), (uint32_t)((k / ST) & 1));
        if (lim < R) {                           // copied rows past the live ones
          uint4* vt = reinterpret_cast<uint4*>(grings + (ring - rings)
                                               + s * S::kStageBytes + S::kTile);
          for (int e = lane; e < (D / 64) * R * 8; e += 32)
            if ((e >> 3) % R >= lim) vt[e] = make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
        cp_async_wait<ST - 1>();
      }
      __syncwarp();                              // every lane's copies landed
      unit(s, lim);
      __syncwarp();                              // stage s is read
      issue(k + ST, iw);
      if (k == n - 1) break;                     // the range's last piece
      if (w.ch == w.nc - 1) {                    // an item ends in the range
        finish(w);
        reset();
      }
      const int b = w.b, kg = w.kg;
      skip(w, 1);
      if (w.b != b || w.kg != kg) load_q(w);
    }
    cp_async_wait<0>();
    finish(w);
  }

  // -- the CTA's split items (at most its first and its last): every
  // warp's partial is out, so the CTA counts itself on each item's arrive
  // counter.  An item of fewer than kDdSpreadPieces pieces is merged whole
  // by the CTA that completes its count, a thread a column, which sets the
  // counter back to 0.  Of a larger one (long rows: ~132 pieces) every CTA
  // holding a piece waits until all have arrived, merges its slice of the
  // columns, 32 lanes a column, and counts itself on the depart
  // counter, whose last CTA sets both back to 0 (one CTA reading the 132
  // partials ran 58 us past the last ring at long_500k,
  // `tools/dense_decode_trace.py`).  Every CTA arrives before it waits,
  // and the cooperative launch keeps every CTA resident, so each wait ends
  __syncthreads();
  int* arrive = p.counters;                    // (B, NG), 0 between launches
  int* depart = p.counters + (long long)B * NG;
  const int np = *npend;
  if (tid == 0) {
    for (int i = 0; i < np; ++i) {
      long long cf, slot0;
      const int npc = pieces(pend[i].item0, pend[i].nc, cf, slot0);
      const int c = pend[i].b * NG + pend[i].kg;
      pend[i].last = add_acq_rel(arrive + c, 1) == npc - 1;
      if (pend[i].last && npc < kDdSpreadPieces) arrive[c] = 0;
    }
  }
  __syncthreads();
  for (int i = 0; i < np; ++i) {
    const DdItem it = pend[i];
    const long long c = (long long)it.b * NG + it.kg;
    long long cf, slot0;
    const int npc = pieces(it.item0, it.nc, cf, slot0);
    if (npc < kDdSpreadPieces) {
      if (it.last) {
        __threadfence();
        merge(it, 0, KG * kC4, 1);
      }
      continue;
    }
    if (tid == 0)
      while (ld_acquire(arrive + c) < npc) __nanosleep(64);
    __syncthreads();
    __threadfence();
    const int own = (int)(blockIdx.x - cf);
    merge(it, (int)((long long)own * KG * kC4 / npc),
          (int)((long long)(own + 1) * KG * kC4 / npc), 32);
    __syncthreads();
    if (tid == 0 && atomicAdd(depart + c, 1) == npc - 1) {
      arrive[c] = 0;
      depart[c] = 0;
    }
  }
}

// -- host side ------------------------------------------------------------------

// The grid: SMs x (CTAs an SM holds), from the occupancy query once per
// device (`static`: each library keeps its own cache and attribute); the
// cooperative launch keeps all of them resident at once.
template <int D, int G>
static int dd_grid() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < 64 && cache[dev] > 0) return cache[dev];
  auto kernel = dense_decode_hopper_kernel<D, G>;
  constexpr int smem = DdShape<D, G>::kSmem;
  int sms = 0, per = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                    DdShape<D, G>::kThreads,
                                                    smem) != cudaSuccess ||
      per < 1)
    return -1;
  const int grid = sms * per;
  if (dev < 64) cache[dev] = grid;
  return grid;
}

// One cooperative launch on stream `s`, with tensor maps over K and V
// (encoded a call; unused at D 96).
template <int D, int G>
static cudaError_t launch_dd_hopper(const DdParams& p, cudaStream_t s) {
  const int grid = dd_grid<D, G>();
  if (grid <= 0) return cudaErrorInvalidConfiguration;
  DdParams q = p;
  q.kg = pd_group(p.Kh, DdShape<D, G>::kWarps);
  CUtensorMap km{}, vm{};
  if constexpr (DdShape<D, G>::kTma) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorInvalidValue;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)p.Kh,
                                (cuuint64_t)p.S, (cuuint64_t)p.B};
    const cuuint64_t strides[3] = {2ull * D, 2ull * D * p.Kh,
                                   2ull * D * p.Kh * p.S};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)DdShape<D, G>::kRows, 1};
    const cuuint32_t step[4] = {1, 1, 1, 1};
    for (int m = 0; m < 2; ++m)
      if (encode(m ? &vm : &km, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                 const_cast<char*>(m ? p.v : p.k), dims, strides, box, step,
                 CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorInvalidValue;
  }
  void* args[] = {&q, &km, &vm};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dense_decode_hopper_kernel<D, G>),
      dim3(grid), dim3(DdShape<D, G>::kThreads), args, DdShape<D, G>::kSmem,
      s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace rt
