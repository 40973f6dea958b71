// Probe of the tensor-core MMA shapes a Hamming tile can use on Hopper
// (sm_90a). Built once per variant by scripts/bmma_probe.py, so that a
// variant ptxas refuses does not stop the others:
//   PROBE_VARIANT 0: mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//   PROBE_VARIANT 1: mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc
//   PROBE_VARIANT 2: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// Each library exports probe_tile (one warp, one MMA on a 16 x 8-word A and
// an 8 x 8-word B in the word map the Hamming kernel uses, for a check on
// the host) and probe_rate (every warp runs `iters` rounds of CHAINS
// independent MMAs, for the instruction rate).
#include <cstdint>
#include <cuda_runtime.h>

#ifndef PROBE_VARIANT
#error "define PROBE_VARIANT"
#endif

namespace {

constexpr int CHAINS = 8;

__device__ __forceinline__ void mma(int32_t (&c)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
#if PROBE_VARIANT == 0
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
#elif PROBE_VARIANT == 1
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
#else
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
#endif
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Lane 4g + t feeds a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][4+t],
// a3 = A[g+8][4+t], b0 = B[g][t], b1 = B[g][4+t]; D[g][2t+e] = c[e],
// D[g+8][2t+e] = c[2+e].
__global__ void tile_kernel(const uint32_t* a, const uint32_t* b, int32_t* d) {
  const int lane = threadIdx.x;
  const int g = lane >> 2, t = lane & 3;
  int32_t c[4] = {0, 0, 0, 0};
  mma(c, a[g * 8 + t], a[(g + 8) * 8 + t], a[g * 8 + 4 + t],
      a[(g + 8) * 8 + 4 + t], b[g * 8 + t], b[g * 8 + 4 + t]);
  for (int e = 0; e < 2; ++e) {
    d[g * 8 + 2 * t + e] = c[e];
    d[(g + 8) * 8 + 2 * t + e] = c[2 + e];
  }
}

__global__ void rate_kernel(int32_t* out, int iters) {
  const uint32_t s = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  int32_t c[CHAINS][4];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      mma(c[j], s, s ^ 1u, s ^ 2u, s ^ 3u, s + j, s - j);
  }
  int32_t sum = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) sum += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

extern "C" int probe_tile(const void* a, const void* b, void* d) {
  tile_kernel<<<1, 32>>>(static_cast<const uint32_t*>(a),
                         static_cast<const uint32_t*>(b), static_cast<int32_t*>(d));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_rate(void* out, int blocks, int threads, int iters,
                          void* stream) {
  rate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_chains() { return CHAINS; }
