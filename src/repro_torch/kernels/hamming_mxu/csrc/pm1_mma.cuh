// The int8 tensor-core Hamming steps of hamming_mxu.cu (the weighted bit
// map below) and fused_search_mxu.cu (the nibble map, pm1_nibble).
//
// Both run on mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32. A is the
// 16-query tile, row-major (k contiguous); B is 8 reference rows,
// column-major, which is each row's own bits with k contiguous.
//
// Fragment layout (PTX ISA, mma.m16n8k32 with .s8), lane = 4 * g + t:
//   A: a0 = row g,   k 4t..4t+3    a1 = row g+8, k 4t..4t+3
//      a2 = row g,   k 16+4t..     a3 = row g+8, k 16+4t..
//   B: b0 = col g,   k 4t..4t+3    b1 = col g,   k 16+4t..
//   C: c0, c1 = row g,   cols 2t, 2t+1;   c2, c3 = row g+8, cols 2t, 2t+1
//
// The nibble map: with bit 0 -> +1 and bit 1 -> -1, dot(x, y) = dim - 2 *
// hamming, so a tile of Hamming distances is (dim - Q . R^T) / 2, exact in
// int32. One packed word is exactly one k32 step (bit b of word w is column
// 32w + b, for the queries and the reference rows alike), so each register
// is the +-1 expansion of one nibble of a packed word: pm1_nibble turns 4
// bits into 4 int8 lanes with a shift, two masks and two integer
// multiplies, never one bit per instruction.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

// The weighted bit map of hamming_mxu.cu. A 16-word step gives lane 4g + t
// words 4t .. 4t + 3 of its row and runs 16 MMAs; MMA m takes bit position
// p = (m & 3) + 4 * (m >> 3) of every byte of the lane's words 2h (b0; a0,
// a1) and 2h + 1 (b1; a2, a3), h = (m >> 2) & 1, so each lane's 128 bits
// meet the step's k slots one to one, and A and B share the map.
//
// A B register is one AND of a packed word, `w & (0x01010101 << p)`: bytes
// r * 2^p, with r the row bit (an s8 -128 for p = 7). The A register holds
// the query bit q as (1 - 2q) * a_p with a_p = 2^(3 - (p & 3)), and
// a_7 = -1, so each product is 8 (1 - 2q) r for p < 4 and 128 (1 - 2q) r
// for p >= 4. MMAs 0..7 sum into a lo accumulator and 8..15 into a hi one:
//   ham(q, r) = |q| + sum_k (1 - 2 q_k) r_k = |q| + (lo >> 3) + (hi >> 7),
// exact in int32 (both shifts divide exactly).
constexpr int PM1_STEP_WORDS = 16;
constexpr int PM1_STEP_MMAS = 16;
constexpr uint32_t BYTE_LSBS = 0x01010101u;

__host__ __device__ constexpr int pm1_bit_pos(int m) { return (m & 3) + ((m >> 3) << 2); }
__host__ __device__ constexpr int pm1_word_pair(int m) { return (m >> 2) & 1; }

// The A register of bits 8j + p of w (j = 0..3): byte j is a_p for a 0 bit
// and -a_p for a 1 bit, formed as zero * 0x01010101 + bits * (one - zero),
// exact mod 2^32 because every byte of the result lies in [0, 255].
__device__ __forceinline__ uint32_t pm1_weighted(uint32_t w, int p) {
  const int a = p == 7 ? -1 : 1 << (3 - (p & 3));
  const uint32_t zero = static_cast<uint32_t>(a) & 0xFFu;
  const uint32_t one = static_cast<uint32_t>(-a) & 0xFFu;
  return zero * BYTE_LSBS + ((w >> p) & BYTE_LSBS) * (one - zero);
}

// Words [w, w + 4) of a row, zero at and past `end`; VEC == 4: one 16-byte
// load (row 16-byte aligned and end % 4 == 0: all four in range or none)
// that asks L2 to fetch the 256-byte block around it, which the next loads
// of the row read.
template <int VEC>
__device__ __forceinline__ uint4 pm1_load4(const uint32_t* row, int w, int end) {
  if constexpr (VEC == 4) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (w < end)
      asm("ld.global.nc.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
          : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
          : "l"(row + w));
    return v;
  } else {
    return make_uint4(w < end ? __ldg(row + w) : 0u, w + 1 < end ? __ldg(row + w + 1) : 0u,
                      w + 2 < end ? __ldg(row + w + 2) : 0u,
                      w + 3 < end ? __ldg(row + w + 3) : 0u);
  }
}

// One step for NT n8 tiles: a_step + lane points at the lane's A register
// quad of MMA 0 (MMA m at a_step[m * 32]); rv[nt] holds the lane's 4 words
// of tile nt's row. Lo and hi MMAs alternate, 2 * NT independent chains.
template <int NT>
__device__ __forceinline__ void mma_weighted_step(int32_t (&lo)[NT][4], int32_t (&hi)[NT][4],
                                                  const uint4* a_step, const uint4 (&rv)[NT]) {
#pragma unroll
  for (int j = 0; j < PM1_STEP_MMAS; ++j) {
    const int m = (j >> 1) + ((j & 1) << 3);
    const int p = pm1_bit_pos(m);
    const uint32_t mask = BYTE_LSBS << p;
    const uint4 a = a_step[m * 32];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t w0 = pm1_word_pair(m) ? rv[nt].z : rv[nt].x;
      const uint32_t w1 = pm1_word_pair(m) ? rv[nt].w : rv[nt].y;
      mma_s8(m < 8 ? lo[nt] : hi[nt], a, w0 & mask, w1 & mask);
    }
  }
}

}  // namespace
