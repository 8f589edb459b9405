// Tensor-core and async-copy building blocks of the bf16 paged decode
// (paged_decode_hopper.cuh; the split-KV body, decode_attention.cuh, uses
// the copies): `cp.async` 16-byte copies into shared memory, `ldmatrix`
// fragment loads, `mma.sync.m16n8k16` with bf16 operands and f32
// accumulators, and the XOR swizzle of shared tiles.  The bf16 flash
// kernel and the bf16 fused head are built on Hopper's TMA and `wgmma`
// instead (hopper.cuh).
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16), for lane = 4 g + t:
//   A (16 x 16, row-major) a0: (g, 2t..2t+1)   a1: (g+8, 2t..)
//                          a2: (g, 2t+8..)     a3: (g+8, 2t+8..)
//   B (16 x 8, "col")      b0: (k 2t..2t+1, n g)  b1: (k 2t+8.., n g)
//   C/D (16 x 8, f32)      c0, c1: (g, 2t..2t+1)  c2, c3: (g+8, 2t..)
// `ldmatrix.x4` loads four 8 x 8 b16 matrices whose row addresses come from
// lanes 8i..8i+7 (matrix i lands in register i); `.trans` hands each lane
// the transposed element pair, which turns rows of a row-major [k][n]
// tile into B fragments.
#pragma once

#include "common.cuh"

namespace rt {

// Byte offset of 16-byte chunk `c` of row `r` in a shared tile whose rows
// are `row_chunks` (>= 8) chunks long.  The chunk index is XORed with
// r % 8, so the same logical chunk of 8 consecutive rows lands in 8
// distinct bank groups: `ldmatrix` and `cp.async` run without conflicts.
__device__ __forceinline__ uint32_t swz(int r, int c, int row_chunks) {
  return static_cast<uint32_t>((r * row_chunks + (c ^ (r & 7))) * 16);
}

// 16-byte asynchronous copy global -> shared.  Only `src_bytes` (0..16)
// are read; the rest of the 16 is zero-filled (0: nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16) * b (16 x 8): bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace rt
