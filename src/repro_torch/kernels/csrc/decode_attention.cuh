// One-token GQA decode attention for f32 q: the split-KV body of the
// paged kernel (paged_decode_attention.cu, fp and int8 pages) and of the
// dense kernel (ragged_decode_attention.cu), as `_flash_decode_block` is
// shared by the three Pallas variants in
// src/repro/kernels/ragged_decode_attention.py.  bf16 q runs the Hopper
// kernels instead (paged_decode_hopper.cuh, dense_decode_hopper.cuh); f32
// q serves the card's f32 checks and the RL session's tiny LM.
//
// What bounds it on the H100: bytes.  Every live K and V row is read once
// (kv_len x Kh x D x 2 tensors x element size per slot) and there are only
// 4 x G flops per element read, far below the ~295 flop/byte the card needs
// before its tensor cores become the limit.  So the design keeps many
// bytes in flight on every SM and spends few instructions per byte:
//   * split-KV over equal row ranges: the grid is (KV head, slot, split)
//     and each CTA takes kDecodeSplitRows rows of one slot for the G query
//     heads that share the KV head (a K/V row is read once for G heads).
//     The longest slot no longer sets the time: its rows spread over many
//     CTAs.  A CTA whose range starts at or past the slot's length exits at
//     once; the splits are derived from the block table's width on the
//     host, which never reads kv_len;
//   * the split's rows are resolved once, at the start: the block-table
//     entries (and, for int8 pages, the pages' scales) are read once per
//     page into shared memory and expanded to one row index (and scale)
//     per row, so no row waits on a table lookup;
//   * K and then V tiles of the split (kDecodeTileBytes each, or 32 or
//     64 rows of the wide rows, 16 B per row of padding so reads have no
//     bank conflicts) stream through a kDecodeStages-deep shared-memory
//     ring filled with `cp.async.cg`, 16 bytes a thread, several tiles in
//     flight;
//   * scores: 4 lanes own a row (a quarter of its 16-B chunks each) and
//     sum over 2 shuffles for all G heads at once; q sits in registers
//     (or, for wide G x D, in shared memory).  The scores of the whole
//     split stay in shared memory, so the softmax runs once per split
//     (one max and one sum per head), with no running rescale.  An int8
//     D 96 row is 6 chunks, which 4 lanes cannot share evenly: its row is
//     padded in shared memory to 8 chunks (a 144-B pitch) and its lanes
//     take 2 each.  The pad chunks are never copied or written, and q is
//     zero at their columns: any byte decodes to a finite integer in
//     [-128, 127], so they add exactly 0 to a score.  Padding keeps the
//     one row split that every other shape runs, where a split of its
//     own (3 lanes of 2 chunks, or 2 of 3) would need other shuffles and
//     another owner for each head's score; the 2 pad chunks cost FMAs on
//     zeros, at G 1 a small share of a byte-bound kernel;
//   * P V: a thread owns 8 columns of D and a row group, accumulates its
//     rows in f32 registers, and the row groups are summed in shared
//     memory once at the end (at D = 192, 5 row groups of 24 threads: the
//     last 8 threads sit out; at D = 96, 10 row groups of 12: the last 8);
//   * int8 rows become f32 by a byte permute and one add (no I2F), and the
//     page scale multiplies the score (K) or the weight (V) once per row;
//     the int8 slot's new row (row len - 1, unquantised, in q's dtype) is
//     not in the pool walk: the split that holds it walks its pool rows up
//     to it and folds the new row in as a separate step;
//   * a slot with one live split writes its output; otherwise each split
//     writes f32 partials (max, sum, unnormalised accumulator) and
//     `decode_merge_kernel`, launched behind it on the same stream, merges
//     the live splits.  kv_len <= 0 gives zeros;
//   * the dense kernel may start a slot's rows at kv_start (left-padded
//     prefills): the live rows are [kv_start, min(kv_len, S)), the
//     slot's row base moves to kv_start and the splits cut that range,
//     so the split pass, the merge and the one-split fast path count
//     splits from kv_start, and kv_start >= kv_len gives zeros.  Only
//     the dense kernel's entry (`DecodeStartParams`) runs it.
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace rt {

constexpr int kDecodeThreads = 128;     // 4 warps
constexpr int kDecodeSplitRows = 256;   // rows of one slot a CTA takes
constexpr int kDecodeStages = 4;        // depth of the cp.async ring
constexpr int kDecodeTileBytes = 8192;  // K or V bytes of one ring stage

// Splits of a slot whose source reaches `rows` rows (the grid's z).
inline int decode_splits(int rows) {
  return rows <= 0 ? 1 : (rows + kDecodeSplitRows - 1) / kDecodeSplitRows;
}

// Rows of a ring stage for rows of D elements, `load_chunks` 16-B copies
// each: the most rows that fit kDecodeTileBytes, a multiple of 8
// (score_tile takes 8 rows for each of the 4 warps) whose copies the 128
// threads divide evenly; rows wider than 128 elements take at least 32,
// a full pass of the 4 warps (their 8 KB holds 16 or 21).  So bf16 D 96
// takes 32 rows (8 KB is 42 2/3; 40 x 12 chunks does not divide), int8
// D 96 64 (85 1/3), int8 D 192 32 (42 2/3), bf16 D 192 and D 256 32,
// f32 D 128 16, and the other shapes the 8 KB tile.
constexpr int decode_tile_rows(int d, int row_bytes, int load_chunks) {
  int rows = kDecodeTileBytes / row_bytes / 8 * 8;
  while (rows > 0 && rows * load_chunks % kDecodeThreads != 0) rows -= 8;
  return d > 128 && rows < 32 ? 32 : rows;
}

template <typename KV, int D>
struct DecodeShape {
  static constexpr int kRowBytes = D * (int)sizeof(KV);
  static constexpr int kLoadChunks = kRowBytes / 16;     // 16-B pieces copied
  // pieces the 4 lanes of a row split: the row's, rounded up to a
  // multiple of 4 (int8 D 96: 6 -> 8, two pad chunks; see the header)
  static constexpr int kChunks = (kLoadChunks + 3) / 4 * 4;
  static constexpr int kRowPitch = kChunks * 16 + 16;    // padded in shared
  static constexpr int kChunkElems = 16 / (int)sizeof(KV);
  static constexpr int kQCols = kChunks * kChunkElems;   // q's padded width
  static constexpr int kTileRows = decode_tile_rows(D, kRowBytes,
                                                    kLoadChunks);
  static constexpr int kStageBytes = kTileRows * kRowPitch;
  static constexpr int kVChunks = D / 8;                 // P V: 8 columns
  static constexpr int kRowGroups = kDecodeThreads / kVChunks;
  static constexpr int kPVThreads = kRowGroups * kVChunks;   // <= 128
  static_assert(kTileRows > 0 && kTileRows % 8 == 0 &&
                kTileRows * kLoadChunks % kDecodeThreads == 0,
                "decode tile shape");
  static_assert(kChunks == kLoadChunks || sizeof(KV) == 1,
                "only int8 rows are padded (other bytes may decode to NaN)");
};

// Dynamic shared memory: a region that holds the ring (and, before it
// fills, the setup's page entries; after it drains, the row groups'
// accumulators), then q, the split's scores, row indices and row scales.
template <typename KV, int D, int G>
__host__ __device__ constexpr int decode_region_bytes() {
  using Sh = DecodeShape<KV, D>;
  constexpr int ring = kDecodeStages * Sh::kStageBytes;
  constexpr int red = Sh::kRowGroups * G * D * 4;
  constexpr int setup = 3 * (kDecodeSplitRows + 1) * 4;
  constexpr int r = ring > red ? ring : red;
  return ((r > setup ? r : setup) + 15) / 16 * 16;
}

template <typename KV, int D, int G>
__host__ __device__ constexpr int decode_smem_bytes() {
  return decode_region_bytes<KV, D, G>()
         + (G * DecodeShape<KV, D>::kQCols + kDecodeSplitRows * G
            + 3 * kDecodeSplitRows + 2 * G) * 4;
}

// Where the rows are and what the kernel writes.  Row r of the CTA's slot
// (global row index rows[r]) of KV head kh starts at
// k + rows[r] * row_stride + kh * D * sizeof(KV).
struct DecodeParams {
  const void* q;             // (B, H, D) of T
  const char* k;
  const char* v;
  long long row_stride;      // bytes: Kh * D * sizeof(KV)
  const int* table;          // (B, nb) block tables; null for dense rows
  int nb, P;                 // table width, page size
  int S;                     // dense: rows a slot holds
  const float* ks;           // int8: (N,) page scales
  const float* vs;
  const void* k_new;         // int8: (B, Kh, D) of T, the new rows
  const void* v_new;
  const int* kv_len;         // (B,)
  const int* kv_start;       // dense: (B,) first live row, or null for 0
  void* out;                 // (B, H, D) of T
  float* part_ml;            // (B, H, splits, 2): max, sum
  float* part_acc;           // (B, H, splits, D)
  int H, Kh, splits, cap;    // cap: rows the source reaches (nb*P or S)
  float scale, softcap;
  float* lse;                // dense: (B, H) f32 log-sum-exp, or null
};

// 16 bytes of K/V storage -> f32.  bf16 is the top half of an f32; an
// int8 x becomes 2^23 + (x + 128) by a byte permute, then loses 2^23 + 128.
__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack_i8x4(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}
template <typename KV>
__device__ __forceinline__ void unpack16(const uint4& w4, float* f) {
  const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(KV) == 4) f[i] = __uint_as_float(w[i]);
    else if constexpr (sizeof(KV) == 2) unpack_bf16x2(w[i], f + 2 * i);
    else unpack_i8x4(w[i], f + 4 * i);
  }
}

// Column of element e (0..7) of P V piece `dc`: 8 adjacent columns, or for
// f32 two runs of 4, at dc*4 and D/2 + dc*4, so 8 lanes read 128
// adjacent bytes in either case.
template <typename KV, int D>
__device__ __forceinline__ int vcol(int dc, int e) {
  if constexpr (sizeof(KV) == 4) return (e < 4 ? 0 : D / 2) + dc * 4 + (e & 3);
  else return dc * 8 + e;
}

template <typename KV, int D>
__device__ __forceinline__ void load_v8(const unsigned char* row, int dc,
                                        float (&v)[8]) {
  if constexpr (sizeof(KV) == 4) {
    unpack16<KV>(*reinterpret_cast<const uint4*>(row + dc * 16), v);
    unpack16<KV>(*reinterpret_cast<const uint4*>(row + D * 2 + dc * 16), v + 4);
  } else if constexpr (sizeof(KV) == 2) {
    unpack16<KV>(*reinterpret_cast<const uint4*>(row + dc * 16), v);
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(row + dc * 8);
    unpack_i8x4(a.x, v);
    unpack_i8x4(a.y, v + 4);
  }
}

// The G weights (or scores) of one row, G floats at p: vector loads where
// G allows them, else one float at a time (G 1 and 3: a row of G = 3 is
// 12 bytes, so rows are not 8-byte aligned).
template <int G>
__device__ __forceinline__ void load_g(const float* p, float (&x)[G]) {
  if constexpr (G % 4 == 0) {
#pragma unroll
    for (int i = 0; i < G; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      x[i] = a.x; x[i + 1] = a.y; x[i + 2] = a.z; x[i + 3] = a.w;
    }
  } else if constexpr (G == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < G; ++i) x[i] = p[i];
  }
}

__device__ __forceinline__ float cap_score(float s, float softcap) {
  return softcap > 0.f ? tanhf(s / softcap) * softcap : s;
}

// Scores of one K tile: rows [row0, row0 + TR) of the split, those below
// `nk` kept.  Lane = 8 * quarter + row in the warp's 8 rows, so the 8
// lanes of a shared-memory phase read one q address (a broadcast) and 8
// rows a padded pitch apart (distinct banks).
template <typename KV, int D, int G, bool kQReg, int QR>
__device__ __forceinline__ void score_tile(
    const unsigned char* st, int row0, int nk, const float (&qr)[G][QR],
    const float* qs, float* sc, const float* ksr, float softcap, int lane,
    int warp) {
  using Sh = DecodeShape<KV, D>;
  constexpr int TR = Sh::kTileRows, QC = Sh::kChunks / 4;
  constexpr int CE = Sh::kChunkElems, QD = Sh::kQCols;
  const int j = lane >> 3;
#pragma unroll
  for (int rr0 = 0; rr0 < TR; rr0 += 32) {
    if (rr0 + warp * 8 < TR) {                // warp-uniform: TR % 8 == 0
      const int rr = rr0 + warp * 8 + (lane & 7);
      const unsigned char* row = st + rr * Sh::kRowPitch + j * QC * 16;
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
      // 4 elements of q, the chunk's e4-th to e4+3-th, of head g
      auto q4 = [&](int g, int c, int e4) {
        if constexpr (kQReg) {
          return make_float4(qr[g][c * CE + e4], qr[g][c * CE + e4 + 1],
                             qr[g][c * CE + e4 + 2], qr[g][c * CE + e4 + 3]);
        } else {
          return *reinterpret_cast<const float4*>(
              qs + g * QD + (j * QC + c) * CE + e4);
        }
      };
#pragma unroll
      for (int c = 0; c < QC; ++c) {
        const uint4 w4 = *reinterpret_cast<const uint4*>(row + c * 16);
        if constexpr (sizeof(KV) == 1) {
          // a word (4 int8) at a time for every head: 4 K values live
          // where the whole chunk's 16 would be (beside G x 8
          // accumulators at G 12 and 16); each s[g] sums in the same
          // order as the branch below
          const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int e4 = 0; e4 < CE; e4 += 4) {
            float kf[4];
            unpack_i8x4(w[e4 / 4], kf);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float4 qv = q4(g, c, e4);
              s[g] = fmaf(qv.x, kf[0], s[g]);
              s[g] = fmaf(qv.y, kf[1], s[g]);
              s[g] = fmaf(qv.z, kf[2], s[g]);
              s[g] = fmaf(qv.w, kf[3], s[g]);
            }
          }
        } else {
          float kf[CE];
          unpack16<KV>(w4, kf);
#pragma unroll
          for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int e4 = 0; e4 < CE; e4 += 4) {
              const float4 qv = q4(g, c, e4);
              s[g] = fmaf(qv.x, kf[e4], s[g]);
              s[g] = fmaf(qv.y, kf[e4 + 1], s[g]);
              s[g] = fmaf(qv.z, kf[e4 + 2], s[g]);
              s[g] = fmaf(qv.w, kf[e4 + 3], s[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 8);
        s[g] += __shfl_xor_sync(0xffffffffu, s[g], 16);
      }
      const int i = row0 + rr;
      if (i < nk) {
        float ksc = 1.f;
        if constexpr (std::is_same<KV, int8_t>::value) ksc = ksr[i];
#pragma unroll
        for (int g = 0; g < G; ++g)
          if ((g & 3) == j) sc[i * G + g] = cap_score(s[g] * ksc, softcap);
      }
    }
  }
}

// Weights of one V tile's rows into the thread's 8 columns of G heads.
template <typename KV, int D, int G>
__device__ __forceinline__ void pv_tile(const unsigned char* st, int row0,
                                        int nk, const float* sc,
                                        float (&acc)[G][8], int tid) {
  using Sh = DecodeShape<KV, D>;
  if constexpr (Sh::kPVThreads < kDecodeThreads) {
    if (tid >= Sh::kPVThreads) return;        // outside the row groups
  }
  const int rg = tid / Sh::kVChunks, dc = tid % Sh::kVChunks;
  const int n = min(Sh::kTileRows, nk - row0);
  for (int rr = rg; rr < n; rr += Sh::kRowGroups) {
    float v[8], p[G];
    load_v8<KV, D>(st + rr * Sh::kRowPitch, dc, v);
    load_g<G>(sc + (row0 + rr) * G, p);
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p[g], v[e], acc[g][e]);
  }
}

// Softmax over the split's n scores, once per head (a warp per head):
// max and sum into ml, weights (times the row's V page scale) into sc.
template <int G, bool kInt8>
__device__ __forceinline__ void split_softmax(float* sc, float* ml,
                                              const float* vsr, int n,
                                              int lane, int warp) {
  for (int g = warp; g < G; g += kDecodeThreads / 32) {
    float mx = -CUDART_INF_F;
    for (int r = lane; r < n; r += 32) mx = fmaxf(mx, sc[r * G + g]);
    mx = warp_max(mx);                        // finite: n >= 1
    float sum = 0.f;
    for (int r = lane; r < n; r += 32) {
      const float e = expf(sc[r * G + g] - mx);
      sum += e;
      sc[r * G + g] = kInt8 ? e * vsr[r] : e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[g] = mx;
      ml[G + g] = sum;
    }
  }
}

// The split pass of the CTA of (KV head blockIdx.x, slot blockIdx.y,
// split blockIdx.z).  kStart: the slot's rows start at p.kv_start (the
// dense kernel's entry below); the paged kernel's entry runs it without.
template <typename T, typename KV, int D, int G, bool kStart>
__device__ __forceinline__ void decode_split(const DecodeParams p) {
  using Sh = DecodeShape<KV, D>;
  constexpr int TR = Sh::kTileRows, NCV = Sh::kVChunks;
  constexpr int NT = kDecodeThreads, SR = kDecodeSplitRows;
  constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  // the lane's quarter of q in registers where it fits beside the f32
  // accumulators without spilling (checked by ptxas for every shape);
  // Gemma2's D 256, G 2 spills 4 bytes with q in shared memory (at 80
  // registers) and none with it in registers (217)
  constexpr int QD = Sh::kQCols;
  constexpr bool kQReg = G * QD / 4 <= (sizeof(KV) == 4 ? 32 : 64) ||
                         (sizeof(KV) == 2 && D == 256 && G == 2);
  constexpr int QR = kQReg ? QD / 4 : 1;
  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the live rows are [st, min(kv_len, cap)); splits count from st
  int st = 0;
  if constexpr (kStart) st = p.kv_start != nullptr ? max(p.kv_start[b], 0) : 0;
  const int len = min(p.kv_len[b], p.cap) - st;
  const int r0 = split * SR;
  T* out = static_cast<T*>(p.out) + ((long long)b * p.H + kh * G) * D;
  if (r0 >= len) {
    if (split == 0) {                         // no live row: zeros
      for (int i = tid; i < G * D; i += NT) out[i] = from_f<T>(0.f);
      if constexpr (kStart) {                 // the dense entry's lse
        if (p.lse != nullptr && tid < G)
          p.lse[(long long)b * p.H + kh * G + tid] = -CUDART_INF_F;
      }
    }
    return;
  }
  const int n = min(SR, len - r0);            // rows of this split
  const bool has_new = kInt8 && len - r0 <= SR;   // holds row len - 1
  const int nk = n - (has_new ? 1 : 0);       // rows read from the pool
  const int ntiles = (nk + TR - 1) / TR;

  extern __shared__ __align__(16) unsigned char rt_decode_smem[];
  unsigned char* ring = rt_decode_smem;
  constexpr int kRegion = decode_region_bytes<KV, D, G>();
  float* qs = reinterpret_cast<float*>(rt_decode_smem + kRegion);
  float* sc = qs + G * QD;                    // (SR, G) scores, then weights
  int* rows = reinterpret_cast<int*>(sc + SR * G);
  float* ksr = reinterpret_cast<float*>(rows + SR);   // int8: row scales
  float* vsr = ksr + SR;
  float* ml = vsr + SR;                       // (2, G): max, sum

  const T* q = static_cast<const T*>(p.q) + ((long long)b * p.H + kh * G) * D;
  for (int i = tid; i < G * QD; i += NT) {   // (G, QD): zero past D
    const int g = i / QD, d = i % QD;
    qs[i] = d < D ? to_f(q[g * D + d]) * p.scale : 0.f;
  }
  if (p.table != nullptr) {
    // the split's table entries (and page scales) once per page, then one
    // row index (and scale) per row; the ring is not in use yet
    int* tbl = reinterpret_cast<int*>(ring);
    float* pks = reinterpret_cast<float*>(tbl + SR + 1);
    float* pvs = pks + SR + 1;
    const int pg0 = r0 / p.P;
    const int npg = nk > 0 ? (r0 + nk - 1) / p.P - pg0 + 1 : 0;
    const int* bt = p.table + (long long)b * p.nb + pg0;
    for (int i = tid; i < npg; i += NT) {
      const int pg = bt[i];
      tbl[i] = pg;
      if constexpr (kInt8) {
        pks[i] = p.ks[pg];
        pvs[i] = p.vs[pg];
      }
    }
    __syncthreads();
    for (int i = tid; i < nk; i += NT) {
      const int t = r0 + i, lp = t / p.P;
      rows[i] = tbl[lp - pg0] * p.P + (t - lp * p.P);
      if constexpr (kInt8) {
        ksr[i] = pks[lp - pg0];
        vsr[i] = pvs[lp - pg0];
      }
    }
  } else {
    for (int i = tid; i < nk; i += NT) rows[i] = b * p.S + st + r0 + i;
  }
  if (has_new && tid == 0) vsr[nk] = 1.f;     // the new row: unquantised
  __syncthreads();

  float qr[G][QR];
  if constexpr (kQReg) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int x = 0; x < QR; ++x) qr[g][x] = qs[g * QD + (lane >> 3) * QR + x];
  }
  if constexpr (kInt8) {
    if (has_new && warp == 0) {               // the new row's scores
      const T* kn = static_cast<const T*>(p.k_new)
                    + ((long long)b * p.Kh + kh) * D;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s = fmaf(qs[g * QD + d], to_f(kn[d]), s);
        s = warp_sum(s);
        if (lane == 0) sc[nk * G + g] = cap_score(s, p.softcap);
      }
    }
  }

  const char* kbase = p.k + (long long)kh * Sh::kRowBytes;
  const char* vbase = p.v + (long long)kh * Sh::kRowBytes;
  const long long row_stride = p.row_stride;
  // ring tile `it`: K tiles 0..ntiles-1, then V tiles; an empty commit past
  // the end keeps the group count uniform
  auto issue = [=](int it) {
    if (it < 2 * ntiles) {
      const bool isv = it >= ntiles;
      const int row0 = (isv ? it - ntiles : it) * TR;
      const char* src = isv ? vbase : kbase;
      const uint32_t dst = smem_u32(ring + (it % kDecodeStages) * Sh::kStageBytes);
#pragma unroll
      for (int c0 = 0; c0 < TR * Sh::kLoadChunks; c0 += NT) {
        const int c = c0 + tid, rr = c / Sh::kLoadChunks;
        const int ch = c % Sh::kLoadChunks;
        if (row0 + rr < nk)
          cp_async16(dst + rr * Sh::kRowPitch + ch * 16,
                     src + (long long)rows[row0 + rr] * row_stride + ch * 16,
                     16);
      }
    }
    cp_async_commit();
  };

  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
#pragma unroll
  for (int s = 0; s < kDecodeStages - 1; ++s) issue(s);
  for (int it = 0; it < 2 * ntiles; ++it) {
    cp_async_wait<kDecodeStages - 2>();
    __syncthreads();                          // tile it landed; it-1 consumed
    issue(it + kDecodeStages - 1);
    const unsigned char* st = ring + (it % kDecodeStages) * Sh::kStageBytes;
    if (it < ntiles) {
      score_tile<KV, D, G, kQReg, QR>(st, it * TR, nk, qr, qs, sc, ksr,
                                      p.softcap, lane, warp);
    } else {
      if (it == ntiles) {
        split_softmax<G, kInt8>(sc, ml, vsr, n, lane, warp);
        __syncthreads();
      }
      pv_tile<KV, D, G>(st, (it - ntiles) * TR, nk, sc, acc, tid);
    }
  }
  if (ntiles == 0) {                          // only the new row
    __syncthreads();
    split_softmax<G, kInt8>(sc, ml, vsr, n, lane, warp);
    __syncthreads();
  }
  cp_async_wait<0>();
  const int dc = tid % NCV;
  if constexpr (kInt8) {
    if (has_new && tid < NCV) {               // fold in the new row's V
      const T* vn = static_cast<const T*>(p.v_new)
                    + ((long long)b * p.Kh + kh) * D;
      float w[G];
      load_g<G>(sc + nk * G, w);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float v = to_f(vn[vcol<KV, D>(dc, e)]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][e] = fmaf(w[g], v, acc[g][e]);
      }
    }
  }

  // sum the row groups' accumulators (over the ring, now idle)
  __syncthreads();
  float* red = reinterpret_cast<float*>(ring);
  const int rg = tid / NCV;
  if (Sh::kPVThreads == NT || tid < Sh::kPVThreads) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* r = red + (rg * G + g) * D;
      *reinterpret_cast<float4*>(r + vcol<KV, D>(dc, 0)) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      *reinterpret_cast<float4*>(r + vcol<KV, D>(dc, 4)) =
          make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  const bool single = len <= SR;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float A = 0.f;
#pragma unroll
    for (int r = 0; r < Sh::kRowGroups; ++r) A += red[(r * G + g) * D + d];
    if (single) {
      out[i] = from_f<T>(A / fmaxf(ml[G + g], 1e-30f));
      if constexpr (kStart) {
        if (p.lse != nullptr && d == 0)
          p.lse[(long long)b * p.H + kh * G + g] = ml[g] + logf(ml[G + g]);
      }
    } else {
      const long long o = ((long long)b * p.H + kh * G + g) * p.splits + split;
      p.part_acc[o * D + d] = A;
      if (d == 0) {
        p.part_ml[2 * o] = ml[g];
        p.part_ml[2 * o + 1] = ml[G + g];
      }
    }
  }
}

// The paged kernel's entry: rows from 0, its code as before kv_start.
template <typename T, typename KV, int D, int G>
__global__ void __launch_bounds__(kDecodeThreads)
decode_split_kernel(const DecodeParams p) {
  decode_split<T, KV, D, G, false>(p);
}

// The dense kernel's entry, rows from p.kv_start: an overload on the
// parameters' type, so both entries keep one name.  One block a
// multiprocessor is all it needs: under the default bound ptxas held its
// bf16 (128, 1) and f32 (64, 2) instantiations at 96 registers and
// spilled 8 bytes.
struct DecodeStartParams : DecodeParams {};

template <typename T, typename KV, int D, int G>
__global__ void __launch_bounds__(kDecodeThreads, 1)
decode_split_kernel(const DecodeStartParams p) {
  decode_split<T, KV, D, G, true>(p);
}

// Merges the live splits of a slot with more than one: weights
// exp(m_s - M), an empty split (m = -inf) weighs 0.  Grid (H, B), D threads.
template <typename T, bool kStart>
__global__ void decode_merge_kernel(const float* __restrict__ pml,
                                    const float* __restrict__ pacc,
                                    const int* __restrict__ kv_len,
                                    const int* __restrict__ kv_start,
                                    T* __restrict__ out,
                                    float* __restrict__ lse, int H, int D,
                                    int splits, int cap) {
  const int h = blockIdx.x, b = blockIdx.y;
  int len = min(kv_len[b], cap);
  if constexpr (kStart) len -= kv_start != nullptr ? max(kv_start[b], 0) : 0;
  if (len <= kDecodeSplitRows) return;        // written by its one split
  const int live = (len + kDecodeSplitRows - 1) / kDecodeSplitRows;
  const long long base = ((long long)b * H + h) * splits;
  float M = -CUDART_INF_F;
  for (int s = 0; s < live; ++s) M = fmaxf(M, pml[2 * (base + s)]);
  float L = 0.f, A = 0.f;
  const int d = threadIdx.x;
  for (int s = 0; s < live; ++s) {
    const float m = pml[2 * (base + s)];
    const float w = m == -CUDART_INF_F ? 0.f : expf(m - M);
    L += w * pml[2 * (base + s) + 1];
    A += w * pacc[(base + s) * D + d];
  }
  out[((long long)b * H + h) * D + d] = from_f<T>(A / fmaxf(L, 1e-30f));
  if constexpr (kStart) {
    if (lse != nullptr && d == 0) lse[(long long)b * H + h] = M + logf(L);
  }
}

// Both passes on stream `s`: the split pass, then (splits > 1) the merge.
// `static`: each library keeps its own `attr`.  A function-local static of
// an external template is one symbol across every loaded library (GNU
// unique), so the paged and dense libraries would share it and the second
// would launch without raising its own kernel's shared-memory limit.
template <typename T, typename KV, int D, int G, bool kStart = false>
static cudaError_t launch_decode(const DecodeParams& p, int B, cudaStream_t s) {
  using P = typename std::conditional<kStart, DecodeStartParams,
                                      DecodeParams>::type;
  void (*kernel)(P) = decode_split_kernel<T, KV, D, G>;
  constexpr int smem = decode_smem_bytes<KV, D, G>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  P args;
  static_cast<DecodeParams&>(args) = p;
  kernel<<<dim3(p.Kh, B, p.splits), kDecodeThreads, smem, s>>>(args);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  decode_merge_kernel<T, kStart><<<dim3(p.H, B), D, 0, s>>>(
      p.part_ml, p.part_acc, p.kv_len, p.kv_start, static_cast<T*>(p.out),
      p.lse, p.H, D, p.splits, p.cap);
  return cudaGetLastError();
}

}  // namespace rt

// Instantiates `LAUNCH(D, G)` for every (D, G) the wrappers admit and
// returns its result from the enclosing function, or falls through.
// (64, 3) is Granite-MoE-3B-A800M (24 query heads over 8 KV heads).
#define RT_DECODE_SHAPES(D_, G_, LAUNCH)                                     \
  RT_DECODE_CASE(64, 1, D_, G_, LAUNCH) RT_DECODE_CASE(64, 2, D_, G_, LAUNCH) \
  RT_DECODE_CASE(64, 3, D_, G_, LAUNCH)                                      \
  RT_DECODE_CASE(64, 4, D_, G_, LAUNCH) RT_DECODE_CASE(64, 8, D_, G_, LAUNCH) \
  RT_DECODE_CASE(128, 1, D_, G_, LAUNCH) RT_DECODE_CASE(128, 2, D_, G_, LAUNCH) \
  RT_DECODE_CASE(128, 4, D_, G_, LAUNCH) RT_DECODE_CASE(128, 8, D_, G_, LAUNCH)
// The wide heads, bf16 q only: Nemotron-4-340B (D 192, 96 query heads
// over 8 KV heads), Gemma2-2B (D 256, G 2), Qwen3-MoE-235B-A22B (D 128,
// 64 query heads over 4 KV heads) and Phi-3-Vision-4.2B (D 96, G 1: 32
// query heads, 32 KV heads), on bf16 K/V; on int8 pages all but Gemma2's,
// which serves on the dense layout only.
#define RT_DECODE_INT8_WIDE_SHAPES(D_, G_, LAUNCH)                            \
  RT_DECODE_CASE(192, 12, D_, G_, LAUNCH)                                     \
  RT_DECODE_CASE(128, 16, D_, G_, LAUNCH) RT_DECODE_CASE(96, 1, D_, G_, LAUNCH)
#define RT_DECODE_WIDE_SHAPES(D_, G_, LAUNCH)                                 \
  RT_DECODE_INT8_WIDE_SHAPES(D_, G_, LAUNCH) RT_DECODE_CASE(256, 2, D_, G_, LAUNCH)
#define RT_DECODE_CASE(DD, GG, D_, G_, LAUNCH) \
  if (D_ == DD && G_ == GG) return LAUNCH(DD, GG);
