// Paged GQA decode attention for Hopper (sm_90a): bf16 q over bf16 or
// int8 pages, one launch a call.
//
// Replaces, for bf16 q, the Pallas TPU kernel `paged_decode_attention` of
// src/repro/kernels/ragged_decode_attention.py:174 (`_paged_kernel`, fp
// pages) and its int8 variant `_paged_kernel_int8` (:120, one f32 scale a
// physical page).  f32 q keeps the split-KV body of decode_attention.cuh.
//
// What bounds it on the H100: bytes.  Every live K and V row is read once,
// and a row of D elements costs 4 G D flops, far below the ~295 flop/byte
// where the tensor cores would become the limit.  The body it replaces lost
// its time around the bytes: a grid sized from the block table's width
// (most CTAs exit at once, the live ones run 1.5 waves), per-CTA setup and
// teardown, a second launch to merge, and at G 12-16 the CUDA-core FMAs.
// The design:
//   * a balanced persistent grid, planned on the device: SMs x (CTAs an SM
//     holds), one CTA an SM in practice (its page rings take ~200 KB).  A
//     unit is one page of a group of KG KV heads of one slot (KG = the most
//     KV heads, up to the CTA's warps, that divide Kh: a page row's KG heads
//     are one run of KG x D elements in the pool).  Every CTA reads kv_len
//     (B ints), counts pages(b) = ceil(min(len, nb P) / P), orders the units
//     by slot, then KV head group, then page, and takes the equal contiguous
//     range [c U / C, (c + 1) U / C) (ranges differ by at most one unit; C
//     is the grid, or U if smaller).  The host never reads kv_len;
//   * one warp a KV head of the group, 8 warps (4 at D >= 192 or G > 8),
//     no producer warp: each warp streams its KV head's rows of each unit's
//     page with `cp.async` (16 bytes a lane; an int8 page's two scales
//     ride in the same group) into a ring of its own, 2 to 4 pages deep by
//     shape (`pd_max_stages`), rows padded by 16 bytes so that `ldmatrix`
//     reads 8 rows of one column chunk from 8 bank groups; lane i resolves
//     the i-th page ahead (its table entry), one round trip for 32 pages.
//     The warps never wait for each other.  TMA was tried first (4-D boxes
//     of one KV head's page, 5-D boxes of a KV-head group's page, bulk row
//     copies): at the serve shape it streamed no faster than the warps'
//     `cp.async` (PERF.md §6);
//   * both products on tensor cores, `mma.sync.m16n8k16` bf16 -> f32, at
//     every G.  The heads are M (G of 16 rows live) and a page's 16 keys are
//     N (two n8 tiles) of S = Q K^T; P is then the A operand of O += P V with
//     no shuffle (its C fragment is P V's A fragment), and V's 16 keys are
//     K.  At G <= 8 half of M is padding, which costs tensor-core issue
//     slots a bytes-bound page has to spare, and keeps one code path from
//     G 1 to G 16 (`wgmma` needs M >= 64 and B in shared memory as bf16,
//     which int8 pages are not).  At D 256 (G <= 8) O^T = V^T P^T instead:
//     D is M, the heads N, and P's score fragment is P^T's B fragment as it
//     stands, so a thread keeps D / 4 accumulators, not D / 2.  q is loaded
//     once per item as A fragments (in registers; at D >= 192 in shared
//     memory).  int8 rows are dequantised on the way into a fragment: an
//     int8 value is an integer in [-128, 127], which bf16 holds exactly.  K:
//     `ldmatrix` hands a lane 4 adjacent bytes of a row, which become the
//     fragment's two column pairs (q's columns are permuted the same way,
//     free since q sits in registers).  V: the transposed `ldmatrix` hands
//     a lane 2 bytes of 2 rows, which become two B fragments of two n8
//     tiles (even and odd columns); the output columns are permuted back
//     when written;
//   * rounding kept where it was: q enters the product unscaled (exact),
//     and 1/sqrt(D), the int8 K page scale and the softcap act on the f32
//     score.  The softmax is online, a running max and sum per warp (no
//     score buffer, so an item of any length fits), in the log2 domain; a
//     page that moves no row's max skips the accumulators' rescale.  The
//     weights enter P V as two bf16 halves, hi = bf16(p) and lo = bf16(p -
//     hi), so they keep about 16 bits, as the f32 weights of the body before
//     and of the Pallas kernel (which computes in f32); the int8 V page
//     scale multiplies p before the split;
//   * the merge inside the kernel: a piece (the pages of an item a CTA
//     takes) that is a whole item writes its output.  A split one is a
//     range's first piece (the item began in an earlier range) or its last:
//     the first, when it ends, writes f32 (max, sum, accumulator) for its
//     KV head's G heads into the workspace slot 2 c, fences and counts
//     itself on the item's counter; the last, at the range's end, reads the
//     counter, and where every other piece is counted it merges at once,
//     its own partial taken from its idle ring (no write, fence or count);
//     else it writes slot 2 c + 1 (2 c where the range holds nothing else)
//     and counts itself.  The warp that brings a counter to the item's piece
//     count merges.  Every merge takes the pieces in CTA order (the weights
//     of `ref.merge_split_partials_ref`, taken online), so the result does
//     not depend on which piece merges, and sets the counter back to 0.
//     Settling a piece when it ends, and merging the last at once, keeps
//     the merge's round trips off the kernel's tail.  No second
//     launch, no per-call allocation: the wrapper keeps the workspace (2 C
//     slots, B Kh counters, zeroed once) per device and stream, so the
//     kernel can be captured in a graph.  A slot with kv_len 0 gets zeros;
//   * int8 pages: the warp that takes an item's last page reads the slot's
//     new row (row len - 1) unquantised from k_new / v_new and folds it into
//     its running softmax in f32, as the body before did.
// Pages are 16 rows (the engine's page size); the wrapper raises on any
// other for bf16 q.  `chip_smoke.py --phase variants` edits kPdMaxStages,
// kPdNarrowStages, kPdWarps and kPdRing and removes either product to time
// the design's parts, and times the split-KV body beside it
// (`split_body`).
#pragma once

#include "hopper.cuh"
#include "mma.cuh"

namespace rt {

constexpr int kPdPage = 16;             // rows of a page
constexpr int kPdWarps = 8;             // warps = most KV heads a unit
constexpr int kPdWideWarps = 4;         // (at D >= 192 or G > 8)
constexpr int kPdRing = 212992;         // bytes of the warps' page rings
constexpr int kPdMaxStages = 4;         // pages in a warp's ring
constexpr int kPdNarrowStages = 2;      // (at 8 warps)
constexpr float kPdLog2e = 1.4426950408889634f;
// a warp's book in shared memory, in 8-byte words: the window of 32
// resolved pages (page and KV head group, a lane each: 32 words) and the
// copy side's walk (4)
constexpr int kPdBook = 32 + 4;

// Consumer warps, one a KV head of a unit: as many as the registers of
// one CTA an SM allow (the wide heads and G 16 keep 96-128 accumulators or
// 64 q registers a thread).
__host__ __device__ constexpr int pd_warps(int D, int G) {
  return D >= 192 || G > 8 ? kPdWideWarps : kPdWarps;
}

// Most pages in a warp's ring: 2 at 8 warps, where 8 warps x 2 pages
// already keep some 64-140 KB an SM in flight and a deeper ring only
// delays every warp's first page (H100, cold L2, the serve shape: 0.0390
// ms against 0.0413 at 4 on fp pages, `2_stage_ring`), else kPdMaxStages
// (at 4 warps 2 pages lose up to 30%: Qwen3-MoE's, Nemotron's int8).
__host__ __device__ constexpr int pd_max_stages(int D, int G) {
  return pd_warps(D, G) == kPdWarps ? kPdNarrowStages : kPdMaxStages;
}

template <typename KV, int D, int G>
struct PdShape {
  static constexpr int kWarps = pd_warps(D, G);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowBytes = D * (int)sizeof(KV);
  static constexpr int kChunks = kRowBytes / 16;        // 16-byte copies
  // a KV head's page row in shared memory, 16 bytes of padding after it:
  // 8 rows of one 16-byte column chunk then lie in 8 distinct bank groups
  static constexpr int kPitch = kRowBytes + 16;
  static constexpr int kTile = kPdPage * kPitch;        // K or V of a page
  static constexpr int kStageBytes = 2 * kTile;         // K, then V
  // q's fragments in shared memory (a copy per warp) rather than in
  // registers at D >= 192, where O takes 96-128 registers a thread
  static constexpr bool kQSmem = D >= 192;
  // O^T = V^T P^T at D 256 (bf16 pages, G <= 8): D as M in 16-row tiles,
  // the heads as N, so a thread keeps D / 4 accumulators instead of D / 2
  // (half of them rows 8..15 of heads that G <= 8 leaves empty); P's score
  // fragment is then P^T's B fragment as it stands
  static constexpr bool kT = D >= 256 && G <= 8 && sizeof(KV) == 2;
  static constexpr int kMTiles = D / 16;
  static constexpr int kQBytes = kQSmem ? kWarps * (D / 16) * 32 * 16 : 0;
  // each warp's ring: its share of kPdRing (less q), 2 to kPdMaxStages
  static constexpr int kStagesRaw = (kPdRing - kQBytes) / kWarps / kStageBytes;
  static constexpr int kMaxStages = pd_max_stages(D, G);
  static constexpr int kStages = kStagesRaw < 2 ? 2
                                 : kStagesRaw > kMaxStages ? kMaxStages
                                                           : kStagesRaw;
  static constexpr int kRingBytes = kWarps * kStages * kStageBytes;
  static constexpr int kGroups = kRowBytes / 32;   // ldmatrix.x4 a page
  static constexpr int kKSteps = D / 16;
  static constexpr int kNTiles = D / 8;
  static constexpr bool kHi = G > 8;               // rows 8..15 live
  // the rings, their pages' scales (k, v), the plan, the warps' books,
  // q; 128 bytes to align the rings
  static constexpr int kSmem = 128 + kRingBytes + 8 * kWarps * kStages + 64
                               + 8 * kWarps * kPdBook + 16 + kQBytes;
  // a piece's partial (G x (2 + D) f32, the sums 32 floats in) fits the
  // warp's ring, where the range's last piece is merged
  static_assert(kRowBytes % 32 == 0 && G <= 16 && D % 16 == 0 &&
                kSmem <= 232448 && 4 * (32 + G * D) <= kStages * kStageBytes,
                "paged decode shape");
};

// KV heads a unit takes: the most, up to the consumer warps, that divide
// Kh (the engine's Kh are powers of two).
__host__ __device__ inline int pd_group(int Kh, int warps) {
  int g = warps < Kh ? warps : Kh;
  while (Kh % g != 0) --g;
  return g;
}

// Where the kernel reads and writes.
struct PdParams {
  const __nv_bfloat16* q;       // (B, H, D)
  const char* k;                // (N, 16, Kh, D) pages of KV
  const char* v;
  const int* table;             // (B, nb)
  const int* kv_len;            // (B,)
  const float* ks;              // int8: (N,) page scales
  const float* vs;
  const __nv_bfloat16* k_new;   // int8: (B, Kh, D), the new rows
  const __nv_bfloat16* v_new;
  __nv_bfloat16* out;           // (B, H, D)
  float* ws;                    // 2 C slots x kg x G x (2 + D) f32
  int* counters;                // (B, Kh), 0 between launches
  int B, H, Kh, nb, kg;         // kg: KV heads a unit, pd_group(Kh, W)
  float scale, softcap;
};

// Byte offset, from a KV head's first row in a stage, of the row this
// lane hands `ldmatrix` for 32-byte column group cg: lanes 0-7 rows 0-7
// and 8-15 rows 8-15 at the group's first 16 bytes, lanes 16-31 the same
// rows at its second (matrices: keys 0-7 / 8-15 x two 16-byte chunks).
template <int Pitch>
struct PdLanes {
  uint32_t o;
  __device__ __forceinline__ explicit PdLanes(int lane)
      : o((lane & 15) * Pitch + 16 * (lane >> 4)) {}
  __device__ __forceinline__ uint32_t at(int cg) const { return o + 32 * cg; }
};

// bf16x2 of two int8 bytes of w (`lo` in the low half), exact: the byte
// x ^ 0x80 becomes 2^23 + x + 128 by a byte permute, then loses 2^23 + 128;
// the f32 of an integer in [-128, 127] has 8 significant bits, so its top
// half is its bf16, and a byte permute packs the two (no conversion unit)
template <int LoByte, int HiByte>
__device__ __forceinline__ uint32_t i8_bf16x2(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u,
                                               0x7540 + LoByte)) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u,
                                               0x7540 + HiByte)) - 8388736.f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// a 4-byte cp.async (an int8 page's scale beside its rows)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// p as bf16 hi and lo halves of one fragment register pair
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - bf_lo(hi), b - bf_hi(hi));
}


template <typename KV, int D, int G>
__global__ void __launch_bounds__(PdShape<KV, D, G>::kThreads, 1)
paged_decode_hopper_kernel(const PdParams p) {
  using S = PdShape<KV, D, G>;
  constexpr bool kInt8 = sizeof(KV) == 1;
  constexpr int W = S::kWarps, ST = S::kStages, NT = S::kThreads;
  const float kInf = CUDART_INF_F;
  extern __shared__ unsigned char rt_pd_smem[];
  const uint32_t raw = smem_u32(rt_pd_smem);
  const uint32_t rings = (raw + 127) & ~127u;
  unsigned char* grings = rt_pd_smem + (rings - raw);
  float* scales = reinterpret_cast<float*>(grings + S::kRingBytes);
  long long* plan = reinterpret_cast<long long*>(scales + 2 * W * ST);
  long long* books = plan + 8;                   // kBook words a warp
  uint4* qsm = reinterpret_cast<uint4*>(                      // kQSmem
      (reinterpret_cast<uintptr_t>(books + W * kPdBook) + 15) & ~uintptr_t(15));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = p.B, Kh = p.Kh, KG = p.kg, NG = Kh / KG;
  const int cap = p.nb * kPdPage;
  int* items = p.counters;                    // (B, Kh) pieces counted
  const auto len_of = [&](int b) { return max(min(__ldg(p.kv_len + b), cap), 0); };
  const auto pages_of = [&](int b) { return (len_of(b) + kPdPage - 1) / kPdPage; };

  // slots with no live row get zeros (no unit reaches them)
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    if (pages_of(b) == 0) {
      __nv_bfloat16* o = p.out + (long long)b * p.H * D;
      for (int i = tid; i < p.H * D; i += NT) o[i] = __float2bfloat16(0.f);
    }
  }

  // -- the plan: U units, this CTA's range [u0, u1)
  if (warp == 0) {
    long long tot = 0;
    for (int b = lane; b < B; b += 32) tot += pages_of(b);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tot += __shfl_xor_sync(0xffffffffu, tot, o);
    const long long U = tot * NG;
    const long long ce = min((long long)gridDim.x, U);
    if (lane == 0) {
      plan[0] = U;
      plan[1] = ce;
      plan[2] = blockIdx.x < ce ? blockIdx.x * U / ce : 0;
      plan[3] = blockIdx.x < ce ? (blockIdx.x + 1) * U / ce : 0;
    }
  }
  __syncthreads();
  const long long U = plan[0], ce = plan[1], u0 = plan[2], n = plan[3] - u0;

  // -- the walk over (slot, KV head group, page)
  struct Walk {
    int b, kg, pg, np, len;
    long long item0;                          // the item's first unit
  };
  const auto next_slot = [&](int b) {
    do { ++b; } while (b < B && pages_of(b) == 0);
    return b;
  };
  // w moved on by r units (r >= 0); past the last slot np is huge
  const auto skip = [&](Walk& w, int r) {
    r += w.pg;
    while (r >= w.np) {
      r -= w.np;
      w.item0 += w.np;
      if (++w.kg == NG) {
        w.kg = 0;
        w.b = next_slot(w.b);
        w.len = w.b < B ? len_of(w.b) : 0;
        w.np = w.b < B ? (w.len + kPdPage - 1) / kPdPage : 1 << 30;
      }
    }
    w.pg = r;
  };
  // the walk at unit u < U (the whole warp): the slot b with NG pre(b) <=
  // u < NG pre(b + 1), pre(b) the pages of the slots before b
  const auto locate = [&](long long u) {
    Walk w{};
    long long pre = 0;
    for (int base = 0; base < B; base += 32) {
      const int b = base + lane;
      const long long x = b < B ? pages_of(b) : 0;
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
        const long long p0 = __shfl_sync(0xffffffffu, exc, src);
        w.b = base + src;
        w.len = len_of(w.b);
        w.np = (w.len + kPdPage - 1) / kPdPage;
        const long long rem = u - NG * p0;
        w.kg = (int)(rem / w.np);
        w.pg = (int)(rem % w.np);
        w.item0 = NG * p0 + (long long)w.kg * w.np;
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
  // this warp's ring: its j-th page in stage j % ST, K then V; the
  // stage's page scales beside it
  const uint32_t ring = rings + cw * ST * S::kStageBytes;
  float* mysc = scales + 2 * cw * ST;
  float* wml = p.ws;                                   // (2 C, KG, G, 2)
  float* wacc = p.ws + 2LL * gridDim.x * KG * G * 2;   // (2 C, KG, G, D)
  const auto cta_of = [&](long long u) { return ((u + 1) * ce - 1) / U; };
  // the pieces of an item in CTA order: piece j > 0 (CTA cf + j, whose
  // range starts inside the item) sits in slot 2 (cf + j), piece 0 in
  // 2 cf, or in 2 cf + 1 where the item starts inside CTA cf's range
  const auto pieces = [&](long long item0, int np, long long& cf,
                          long long& slot0) {
    cf = cta_of(item0);
    slot0 = 2 * cf + (cf * U / ce >= item0 ? 0 : 1);
    return (int)(cta_of(item0 + np - 1) - cf + 1);
  };

  // the copies of unit u's page rows of this warp's KV head, 16 bytes a
  // lane at a time, one cp.async group a unit (an empty one past the
  // range); lane i resolves unit c0 + i of a window of 32 (one round trip
  // for 32 table entries and scales)
  // (in this warp's book, out of the registers the wide heads need)
  long long* book = books + cw * kPdBook;
  int* c_page = reinterpret_cast<int*>(book);           // [32]
  int* c_kg = c_page + 32;
  Walk* pw = reinterpret_cast<Walk*>(book + 32);        // unit c0's walk
  long long c0 = -32;
  const long long rowb = (long long)Kh * S::kRowBytes;
  const auto issue = [&](long long u) {
    if (u < n) {
      if (u >= c0 + 32) {
        Walk x = *pw;
        if (c0 >= 0) skip(x, 32);
        c0 += 32;
        __syncwarp();
        if (lane == 0) *pw = x;
        skip(x, lane);
        c_kg[lane] = x.kg;
        if (c0 + lane < n)
          c_page[lane] = __ldg(p.table + (long long)x.b * p.nb + x.pg);
        __syncwarp();
      }
      const int i = (int)(u - c0), s = (int)(u % ST);
      const int pg_i = c_page[i], kg_i = c_kg[i];
      if (kInt8 && lane == 0) {                 // the page's scales
        cp_async4(smem_u32(mysc + 2 * s), p.ks + pg_i);
        cp_async4(smem_u32(mysc + 2 * s + 1), p.vs + pg_i);
      }
      const long long off = (long long)pg_i * kPdPage * rowb
                            + (long long)(kg_i * KG + cw) * S::kRowBytes;
      const uint32_t dst = ring + s * S::kStageBytes;
#pragma unroll
      for (int c0_ = 0; c0_ < kPdPage * S::kChunks; c0_ += 32) {
        const int c = c0_ + lane;
        if (c < kPdPage * S::kChunks) {
          const int r = c / S::kChunks, ch = c - r * S::kChunks;
          const long long so = off + r * rowb + ch * 16;
          cp_async16(dst + r * S::kPitch + ch * 16, p.k + so, 16);
          cp_async16(dst + S::kTile + r * S::kPitch + ch * 16, p.v + so, 16);
        }
      }
    }
    cp_async_commit();
  };

  // q of the KV head's G heads as A fragments (rows g and g + 8), columns
  // natural for bf16 pages, permuted for int8 pages (see the header); in
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
          if constexpr (kInt8) {
            const uint2 v = *reinterpret_cast<const uint2*>(qb + h * D + 16 * j + 4 * t);
            x0 = v.x;
            x1 = v.y;
          } else {
            x0 = *reinterpret_cast<const uint32_t*>(qb + h * D + 16 * j + 2 * t);
            x1 = *reinterpret_cast<const uint32_t*>(qb + h * D + 16 * j + 2 * t + 8);
          }
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
  const auto score = [&](float v, float mul) {
    v *= mul;
    if (p.softcap > 0.f) v = tanhf(v / p.softcap) * p.softcap;
    return v * kPdLog2e;
  };
  // online softmax step of row r (head g + 8 r) with new max candidate mx
  // (already reduced over the quad); returns the reference the weights
  // are taken against (most pages leave every row's max where it was:
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

  // this warp's KV head of a page (16 keys) in ring stage s; `lim` rows
  // of it are read
  const auto page = [&](int s, int lim) {
    const uint32_t kst = ring + s * S::kStageBytes;
    const uint32_t vst = kst + S::kTile;
    float sa[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int cg = 0; cg < S::kGroups; ++cg) {
      uint32_t r[4];
      ldmatrix_x4(r, kst + lanes.at(cg));
      if constexpr (kInt8) {
        // r0/r1: keys 0-7 / 8-15 of chunk 2 cg, r2/r3 of chunk 2 cg + 1
        uint32_t a[4];
        qfrag(2 * cg, a);
        mma_bf16(sa, a, i8_bf16x2<0, 1>(r[0]), i8_bf16x2<2, 3>(r[0]));
        mma_bf16(sb, a, i8_bf16x2<0, 1>(r[1]), i8_bf16x2<2, 3>(r[1]));
        qfrag(2 * cg + 1, a);
        mma_bf16(sa, a, i8_bf16x2<0, 1>(r[2]), i8_bf16x2<2, 3>(r[2]));
        mma_bf16(sb, a, i8_bf16x2<0, 1>(r[3]), i8_bf16x2<2, 3>(r[3]));
      } else {
        // r0/r1: keys 0-7 / 8-15 of columns 16 cg..+7, r2/r3 of +8..+15
        uint32_t a[4];
        qfrag(cg, a);
        mma_bf16(sa, a, r[0], r[2]);
        mma_bf16(sb, a, r[1], r[3]);
      }
    }
    const float mul = p.scale * (kInt8 ? mysc[2 * s] : 1.f);
    const float vsc = kInt8 ? mysc[2 * s + 1] : 1.f;
    float x[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 2 * t + (e & 1);
      x[0][e] = key < lim ? score(sa[e], mul) : -kInf;
      x[1][e] = key + 8 < lim ? score(sb[e], mul) : -kInf;
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
          pw[tt][e] *= vsc;                   // int8: V's page scale
        }
      l[r] += ps;
    }
    uint32_t ah[4], al[4];
    split_bf16(pw[0][0], pw[0][1], ah[0], al[0]);    // row g, keys 2t..
    split_bf16(pw[1][0], pw[1][1], ah[2], al[2]);    // row g, keys 8+2t..
    split_bf16(pw[0][2], pw[0][3], ah[1], al[1]);    // row g + 8
    split_bf16(pw[1][2], pw[1][3], ah[3], al[3]);
#pragma unroll
    for (int cg = 0; cg < S::kGroups; ++cg) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, vst + lanes.at(cg));
      if constexpr (kInt8) {
        // r0/r1 keys 0-7 / 8-15 of chunk 2 cg: bytes (2t, 2g), (2t, 2g+1),
        // (2t+1, 2g), (2t+1, 2g+1); tiles 4 cg (even columns), 4 cg + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int nt = 4 * cg + 2 * h;
          const uint32_t e0 = i8_bf16x2<0, 2>(r[2 * h]),
                         e1 = i8_bf16x2<0, 2>(r[2 * h + 1]);
          const uint32_t d0 = i8_bf16x2<1, 3>(r[2 * h]),
                         d1 = i8_bf16x2<1, 3>(r[2 * h + 1]);
          mma_bf16(o[nt], ah, e0, e1);
          mma_bf16(o[nt], al, e0, e1);
          mma_bf16(o[nt + 1], ah, d0, d1);
          mma_bf16(o[nt + 1], al, d0, d1);
        }
      } else if constexpr (S::kT) {
        // V^T rows 16 cg..+15 as A: r0/r2 keys 0-7 of columns +0..7 /
        // +8..15, r1/r3 keys 8-15; P^T as B: P's rows g, keys 2t.. and 8+2t..
        const uint32_t a[4] = {r[0], r[2], r[1], r[3]};
        mma_bf16(o[cg], a, ah[0], ah[2]);
        mma_bf16(o[cg], a, al[0], al[2]);
      } else {
        mma_bf16(o[2 * cg], ah, r[0], r[1]);
        mma_bf16(o[2 * cg], al, r[0], r[1]);
        mma_bf16(o[2 * cg + 1], ah, r[2], r[3]);
        mma_bf16(o[2 * cg + 1], al, r[2], r[3]);
      }
    }
  };

  // int8: the slot's new row (row len - 1), unquantised, in f32
  const auto new_row = [&](const Walk& w) {
    const long long row = ((long long)w.b * Kh + w.kg * KG + cw) * D;
    const __nv_bfloat16* kn = p.k_new + row;
    const __nv_bfloat16* vn = p.v_new + row;
    float d[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < S::kKSteps; ++j) {
      const uint2 kk = *reinterpret_cast<const uint2*>(kn + 16 * j + 4 * t);
      uint32_t a[4];
      qfrag(j, a);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        d[r] = fmaf(bf_lo(a[r]), bf_lo(kk.x), d[r]);
        d[r] = fmaf(bf_hi(a[r]), bf_hi(kk.x), d[r]);
        d[r] = fmaf(bf_lo(a[2 + r]), bf_lo(kk.y), d[r]);
        d[r] = fmaf(bf_hi(a[2 + r]), bf_hi(kk.y), d[r]);
      }
    }
    float pn[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < (S::kHi ? 2 : 1); ++r) {
      d[r] += __shfl_xor_sync(0xffffffffu, d[r], 1);
      d[r] += __shfl_xor_sync(0xffffffffu, d[r], 2);
      const float sv = score(d[r], p.scale);
      const float ref = rescale(r, sv);
      pn[r] = fast_exp2(sv - ref);
      if (t == 0) l[r] += pn[r];
    }
#pragma unroll
    for (int ch = 0; ch < D / 16; ++ch) {
      const uint2 vv = *reinterpret_cast<const uint2*>(vn + 16 * ch + 4 * t);
      const float v[4] = {bf_lo(vv.x), bf_hi(vv.x), bf_lo(vv.y), bf_hi(vv.y)};
#pragma unroll
      for (int r = 0; r < (S::kHi ? 2 : 1); ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          o[2 * ch][2 * r + e] = fmaf(pn[r], v[2 * e], o[2 * ch][2 * r + e]);
          o[2 * ch + 1][2 * r + e] = fmaf(pn[r], v[2 * e + 1],
                                          o[2 * ch + 1][2 * r + e]);
        }
    }
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
  // f(head, column, v0, v1) over this lane's accumulator pairs, v0 at the
  // column and v1 at the next: bf16 V natural (tile nt, 8 nt + 2 t); int8
  // V's even and odd columns of 16-column chunk ch from tiles 2 ch and
  // 2 ch + 1 (16 ch + 4 t + 2 e)
  const auto pairs = [&](auto&& f) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int h = g + 8 * r;
      if (h >= G || (r == 1 && !S::kHi)) continue;
      if constexpr (kInt8) {
#pragma unroll
        for (int ch = 0; ch < D / 16; ++ch)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            f(h, 16 * ch + 4 * t + 2 * e, o[2 * ch][2 * r + e],
              o[2 * ch + 1][2 * r + e]);
      } else {
#pragma unroll
        for (int nt = 0; nt < S::kNTiles; ++nt)
          f(h, 8 * nt + 2 * t, o[nt][2 * r], o[nt][2 * r + 1]);
      }
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
  };
  // a split piece's partial: (max, sum) of its G heads at ml, the f32
  // accumulators (G x D) at acc
  const auto store = [&](float* ml, float* acc) {
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
  };

  // the merge of a split item's pieces, in piece order (the weights
  // exp(m_j - M) of merge_split_partials_ref, taken online, M the running
  // max; so the result does not depend on which piece merges): kX column
  // groups of 4 a lane and kJ pieces at a time, every load of a batch in
  // flight together (kJ 4 where the registers allow).  Piece js (-1:
  // none) is read from this warp's ring (sml, sacc), the others from the
  // workspace (L2)
  const auto merge = [&](const Walk& w, int js, const float* sml,
                         const float* sacc) {
    constexpr int kV4 = G * D / 4, kPer = (kV4 + 31) / 32;
    constexpr int kX = kPer < 4 ? kPer : 4, kJ = kPer <= 4 ? 4 : 2;
    long long cf, slot0;
    const int npc = pieces(w.item0, w.np, cf, slot0);
    const int kh = w.kg * KG + cw;
    __nv_bfloat16* out = p.out + ((long long)w.b * Kh + kh) * G * D;
    for (int x0 = 0; x0 < kPer; x0 += kX) {
      float M[kX], L[kX];
      float4 A[kX];
#pragma unroll
      for (int x = 0; x < kX; ++x) {
        M[x] = -kInf;
        L[x] = 0.f;
        A[x] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int j0 = 0; j0 < npc; j0 += kJ) {
        float mj[kJ][kX], lj[kJ][kX];
        float4 aj[kJ][kX];
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
          for (int x = 0; x < kX; ++x) {
            const int j = j0 + jj, v = lane + 32 * (x0 + x);
            mj[jj][x] = -kInf;
            if (j < npc && v < kV4) {
              const int h = 4 * v / D, d = 4 * v - h * D;
              if (j == js) {
                mj[jj][x] = sml[2 * h];
                lj[jj][x] = sml[2 * h + 1];
                aj[jj][x] = *reinterpret_cast<const float4*>(sacc + h * D + d);
              } else {
                const long long sl = j == 0 ? slot0 : 2 * (cf + j);
                const long long bs = (sl * KG + cw) * G + h;
                mj[jj][x] = __ldcg(wml + bs * 2);
                lj[jj][x] = __ldcg(wml + bs * 2 + 1);
                aj[jj][x] = __ldcg(reinterpret_cast<const float4*>(wacc + bs * D + d));
              }
            }
          }
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
          for (int x = 0; x < kX; ++x) {
            if (mj[jj][x] == -kInf) continue;
            const float mn = fmaxf(M[x], mj[jj][x]);
            const float a = fast_exp2(M[x] - mn), b = fast_exp2(mj[jj][x] - mn);
            const float4 c = aj[jj][x];
            L[x] = fmaf(L[x], a, lj[jj][x] * b);
            A[x] = make_float4(fmaf(A[x].x, a, c.x * b), fmaf(A[x].y, a, c.y * b),
                               fmaf(A[x].z, a, c.z * b), fmaf(A[x].w, a, c.w * b));
            M[x] = mn;
          }
      }
#pragma unroll
      for (int x = 0; x < kX; ++x) {
        const int v = lane + 32 * (x0 + x);
        if (v < kV4) {
          const float inv = 1.f / fmaxf(L[x], 1e-30f);
          *reinterpret_cast<uint2*>(out + 4 * v) =
              make_uint2(pack_bf16(A[x].x * inv, A[x].y * inv),
                         pack_bf16(A[x].z * inv, A[x].w * inv));
        }
      }
    }
  };

  // a split piece into its workspace slot (slot0 for the item's first
  // CTA, else the CTA's first slot), then counted on its item's counter
  // (one fence orders the partial before the count); true where this warp
  // brought the counter to the item's piece count (set back to 0): it
  // must merge the item
  const auto settle = [&](const Walk& w) {
    long long cf, slot0;
    const int npc = pieces(w.item0, w.np, cf, slot0);
    const long long slot = blockIdx.x == cf ? slot0 : 2LL * blockIdx.x;
    const long long base = (slot * KG + cw) * G;
    store(wml + base * 2, wacc + base * D);
    __threadfence();
    __syncwarp();
    int* c = items + (long long)w.b * Kh + w.kg * KG + cw;
    bool last = false;
    if (lane == 0) {
      last = atomicAdd(c, 1) + 1 == npc;
      if (last) atomicExch(c, 0);
    }
    return __shfl_sync(0xffffffffu, last, 0);
  };

  if (!active || n == 0) return;
  Walk w = locate(u0);
  // the range's first piece, where it was the last of its item to count:
  // merged after the loop (its batches' registers would spill in it)
  bool first_merge = false;
  Walk first{};
  if (lane == 0) *pw = w;
  __syncwarp();
  for (int u = 0; u < ST; ++u) issue(u);
  load_q(w);
  reset();
  for (long long k = 0;; ++k) {
    const int s = (int)(k % ST);
    cp_async_wait<ST - 1>();
    __syncwarp();                                // every lane's copies landed
    // rows read from the pool: the item's len, less the int8 new row
    const int lim = w.len - (kInt8 ? 1 : 0) - kPdPage * w.pg;
    page(s, lim);
    __syncwarp();                                // stage s is read
    issue(k + ST);
    if constexpr (kInt8) {
      if (w.pg == w.np - 1) new_row(w);
    }
    if (k == n - 1) break;                       // the range's last piece
    if (w.pg == w.np - 1) {
      // the end of an item inside the range: a whole item, or the range's
      // first piece (the item began in an earlier range), counted now so
      // that the item's other pieces can merge without waiting for this
      // range's end
      sums();
      long long cf, slot0;
      if (pieces(w.item0, w.np, cf, slot0) == 1) {
        write_out(w);
      } else if (settle(w)) {
        first_merge = true;
        first = w;
      }
      reset();
    }
    const int b = w.b, kg = w.kg;
    skip(w, 1);
    if (w.b != b || w.kg != kg) load_q(w);
  }
  cp_async_wait<0>();
  __syncwarp();
  if (first_merge) {
    __threadfence();
    merge(first, -1, nullptr, nullptr);
  }

  // -- the range's last piece.  Split (it runs on into the next range, or
  // is a middle piece): where every other piece is counted already, it
  // merges at once from its registers (by way of its idle ring) and the
  // other partials, without a partial, a fence or a count of its own
  sums();
  long long cf, slot0;
  const int npc = pieces(w.item0, w.np, cf, slot0);
  if (npc == 1) {
    write_out(w);
    return;
  }
  int* c = items + (long long)w.b * Kh + w.kg * KG + cw;
  int done = 0;
  if (lane == 0) done = atomicAdd(c, 0);
  if (__shfl_sync(0xffffffffu, done, 0) == npc - 1) {
    float* sml = reinterpret_cast<float*>(grings + cw * ST * S::kStageBytes);
    float* sacc = sml + 32;
    store(sml, sacc);
    __threadfence();
    __syncwarp();
    if (lane == 0) atomicExch(c, 0);
    merge(w, (int)(blockIdx.x - cf), sml, sacc);
  } else if (settle(w)) {
    __threadfence();
    merge(w, -1, nullptr, nullptr);
  }
}

// -- host side ------------------------------------------------------------------

// The grid: SMs x (CTAs an SM holds), from the occupancy query once per
// device (`static`: each library keeps its own cache and attribute).
template <typename KV, int D, int G>
static int pd_grid() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dev < 64 && cache[dev] > 0) return cache[dev];
  auto kernel = paged_decode_hopper_kernel<KV, D, G>;
  constexpr int smem = PdShape<KV, D, G>::kSmem;
  int sms = 0, per = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
          != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                    PdShape<KV, D, G>::kThreads,
                                                    smem) != cudaSuccess ||
      per < 1)
    return -1;
  const int grid = sms * per;
  if (dev < 64) cache[dev] = grid;
  return grid;
}

// One launch on stream `s`.
template <typename KV, int D, int G>
static cudaError_t launch_pd_hopper(const PdParams& p, cudaStream_t s) {
  const int grid = pd_grid<KV, D, G>();
  if (grid <= 0) return cudaErrorInvalidConfiguration;
  PdParams q = p;
  q.kg = pd_group(p.Kh, PdShape<KV, D, G>::kWarps);
  paged_decode_hopper_kernel<KV, D, G>
      <<<grid, PdShape<KV, D, G>::kThreads, PdShape<KV, D, G>::kSmem, s>>>(q);
  return cudaGetLastError();
}

}  // namespace rt
