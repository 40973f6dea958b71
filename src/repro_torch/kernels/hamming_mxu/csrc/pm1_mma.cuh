// The +-1 int8 tensor-core Hamming tile shared by hamming_mxu.cu and
// fused_search_mxu.cu.
//
// With bit 0 -> +1 and bit 1 -> -1, dot(x, y) = dim - 2 * hamming, so a
// tile of Hamming distances is (dim - Q . R^T) / 2, exact in int32. The
// product runs on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32: one
// packed word is exactly one k32 step (bit b of word w is column 32w + b,
// for the queries and the reference rows alike). A is the 16-query tile,
// row-major (k contiguous); B is 8 reference rows, column-major, which is
// each row's own bits with k contiguous.
//
// Fragment layout (PTX ISA, mma.m16n8k32 with .s8), lane = 4 * g + t:
//   A: a0 = row g,   k 4t..4t+3    a1 = row g+8, k 4t..4t+3
//      a2 = row g,   k 16+4t..     a3 = row g+8, k 16+4t..
//   B: b0 = col g,   k 4t..4t+3    b1 = col g,   k 16+4t..
//   C: c0, c1 = row g,   cols 2t, 2t+1;   c2, c3 = row g+8, cols 2t, 2t+1
// so each register is the +-1 expansion of one nibble of a packed word:
// pm1_nibble turns 4 bits into 4 int8 lanes with a shift, two masks and
// two integer multiplies, never one bit per instruction.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MMA_NT = 4;     // n8 tiles per warp: 32 reference rows

// Bits [shift, shift+4) of w as four int8 lanes: +1 (0x01) for a 0 bit,
// -1 (0xFF) for a 1 bit, bit shift+j in byte j. The multiply by 0x204081
// moves bit j to bit 8j without carries (the four copies do not overlap).
__device__ __forceinline__ uint32_t pm1_nibble(uint32_t w, int shift) {
  const uint32_t x = (w >> shift) & 0xFu;
  return ((x * 0x00204081u) & 0x01010101u) * 0xFEu + 0x01010101u;
}

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// Unpack words [w0, w0 + nw) of a 16-query tile (q: row stride W, nq valid
// rows, the rest read as 0) into A fragments: s_a[w * 32 + lane] holds lane's
// four registers for word w0 + w. Called by all `nthreads` threads.
__device__ __forceinline__ void stage_a_fragments(uint4* s_a, const uint32_t* q,
                                                  int nq, int W, int w0, int nw,
                                                  int tid, int nthreads) {
  for (int i = tid; i < nw * 32; i += nthreads) {
    const int w = w0 + (i >> 5);
    const int g = (i & 31) >> 2;
    const int t = i & 3;
    const uint32_t lo = g < nq ? q[(size_t)g * W + w] : 0u;
    const uint32_t hi = g + 8 < nq ? q[(size_t)(g + 8) * W + w] : 0u;
    s_a[i] = make_uint4(pm1_nibble(lo, 4 * t), pm1_nibble(hi, 4 * t),
                        pm1_nibble(lo, 16 + 4 * t), pm1_nibble(hi, 16 + 4 * t));
  }
}

// Accumulate the +-1 dot of the staged A fragments (nw words) with the
// warp's MMA_NT x 8 reference rows into c. rows[nt] points at word 0 of the
// row this lane's group feeds to n-tile nt (nullptr: a row past the end,
// read as zeros). VEC == 4 loads 16 bytes at a time and needs nw % 4 == 0
// and 16-byte aligned rows. All 32 lanes must call it.
template <int VEC>
__device__ __forceinline__ void mma_pm1_rows(int32_t (&c)[MMA_NT][4],
                                             const uint4* s_a,
                                             const uint32_t* const (&rows)[MMA_NT],
                                             int nw, int lane) {
  const int t = lane & 3;
  for (int w = 0; w < nw; w += VEC) {
    uint32_t rw[MMA_NT][VEC];
#pragma unroll
    for (int nt = 0; nt < MMA_NT; ++nt) {
      if constexpr (VEC == 4) {
        const uint4 v = rows[nt] ? __ldg(reinterpret_cast<const uint4*>(rows[nt] + w))
                                 : make_uint4(0u, 0u, 0u, 0u);
        rw[nt][0] = v.x;
        rw[nt][1] = v.y;
        rw[nt][2] = v.z;
        rw[nt][3] = v.w;
      } else {
        rw[nt][0] = rows[nt] ? __ldg(rows[nt] + w) : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint4 a = s_a[(w + j) * 32 + lane];
#pragma unroll
      for (int nt = 0; nt < MMA_NT; ++nt)
        mma_s8(c[nt], a, pm1_nibble(rw[nt][j], 4 * t),
               pm1_nibble(rw[nt][j], 16 + 4 * t));
    }
  }
}

}  // namespace
