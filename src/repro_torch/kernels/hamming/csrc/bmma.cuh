// The binary tensor-core step shared by hamming_matrix.cu and
// fused_search.cu: mma.sync m16n8k256 .b1 AND-popc and the 16-byte row
// loads that feed it.
//
// One step is 16 packed words, two MMAs. Lane 4g + t holds words
// 16s + 4t .. 16s + 4t + 3 of B row g (one 16-byte load) and the same words
// of A rows g and g + 8; words + {0, 1} feed the first MMA (a0/a1 = rows
// g / g + 8 at word +0, a2/a3 at word +1; b0, b1) and words + {2, 3} the
// second. A and B share one bit-to-k map, so the k sum is popc(q & r).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int STEP_WORDS = 16;              // two m16n8k256 MMAs

__device__ __forceinline__ void mma_and_popc(int32_t (&c)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four words [w, w + 4) of a row, zero past W; VEC == 4: one 16-byte load
// (W % 4 == 0, so the four are all in range or all out).
template <int VEC>
__device__ __forceinline__ uint4 load4(const uint32_t* row, int w, int W) {
  if constexpr (VEC == 4) {
    return w < W ? __ldg(reinterpret_cast<const uint4*>(row + w))
                 : make_uint4(0u, 0u, 0u, 0u);
  } else {
    return make_uint4(w < W ? __ldg(row + w) : 0u, w + 1 < W ? __ldg(row + w + 1) : 0u,
                      w + 2 < W ? __ldg(row + w + 2) : 0u,
                      w + 3 < W ? __ldg(row + w + 3) : 0u);
  }
}

}  // namespace
