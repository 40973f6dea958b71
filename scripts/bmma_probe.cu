// Probe of the tensor-core MMA shapes a Hamming tile can use on Hopper
// (sm_90a). Built once per variant by scripts/bmma_probe.py, so that a
// variant ptxas refuses does not stop the others:
//   PROBE_VARIANT 0: mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc
//   PROBE_VARIANT 1: mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc
//   PROBE_VARIANT 2: mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32
// Each library exports probe_tile (one warp, one MMA on a 16 x 8-word A and
// an 8 x 8-word B in the word map the Hamming kernel uses, for a check on
// the host), probe_rate (every warp runs `iters` rounds of CHAINS
// independent MMAs, for the instruction rate) and probe_fused_rate (the
// fused search kernels' shape: one CTA of 8 warps per SM, 8 x 4 independent
// accumulators per warp, each A fragment read from shared memory once per
// step and used on 4 MMAs; `expand` picks how each B operand comes from a
// packed word: 0 the word itself, 1 the +-1 expansion of a nibble as
// fused_search_mxu.cu computes it, 2 a shift and an AND (0/1 bytes of a
// strided bit map), 3 one AND (0 / 2^p bytes, hamming_mxu.cu's weighted
// map)) and probe_tile_rate (hamming_mxu.cu's shape: one CTA of 8 warps
// per SM, one query tile, 4 n8 tiles and 8 accumulators per warp, every
// MMA's B operand made from a packed word of its own by `expand`).
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

// +-1 int8 lanes of bits [shift, shift + 4) of w (pm1_mma.cuh's pm1_nibble).
__device__ __forceinline__ uint32_t pm1_nibble(uint32_t w, int shift) {
  const uint32_t x = (w >> shift) & 0xFu;
  return ((x * 0x00204081u) & 0x01010101u) * 0xFEu + 0x01010101u;
}

constexpr int FUSED_TILES = 8;     // A fragments (query tiles) per step
constexpr int FUSED_NT = 4;        // B fragments (n8 row tiles) per step

// B register `reg` (0 or 1) of lane t from packed word w, by expand mode.
template <int EXPAND>
__device__ __forceinline__ uint32_t b_operand(uint32_t w, int t, int reg) {
  if constexpr (EXPAND == 1) return pm1_nibble(w, 16 * reg + 4 * t);
  if constexpr (EXPAND == 2) return (w >> (4 * reg + t)) & 0x01010101u;
  if constexpr (EXPAND == 3) return w & (0x01010101u << (4 * reg + 1));
  return reg ? w >> 1 : w;
}

template <int EXPAND>
__global__ void fused_rate_kernel(int32_t* out, int iters) {
  __shared__ uint4 s_a[FUSED_TILES * 32];
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const uint32_t s = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  for (int i = threadIdx.x; i < FUSED_TILES * 32; i += blockDim.x)
    s_a[i] = make_uint4(s, s ^ 5u, s + 7u, s * 3u);
  __syncthreads();
  int32_t c[FUSED_TILES][FUSED_NT][4];
#pragma unroll
  for (int j = 0; j < FUSED_TILES; ++j)
#pragma unroll
    for (int n = 0; n < FUSED_NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[j][n][i] = 0;
  uint32_t w[FUSED_NT] = {s, s * 7u, s ^ 0x55u, s + 99u};
  for (int it = 0; it < iters; ++it) {
    uint32_t b0[FUSED_NT], b1[FUSED_NT];
#pragma unroll
    for (int n = 0; n < FUSED_NT; ++n) {
      w[n] = w[n] * 1664525u + 1013904223u;           // a new packed word
      b0[n] = b_operand<EXPAND>(w[n], t, 0);
      b1[n] = b_operand<EXPAND>(w[n], t, 1);
    }
    uint4 a[FUSED_TILES];
#pragma unroll
    for (int j = 0; j < FUSED_TILES; ++j) a[j] = s_a[((it + j) & 7) * 32 + lane];
#pragma unroll
    for (int j = 0; j < FUSED_TILES; ++j)
#pragma unroll
      for (int n = 0; n < FUSED_NT; ++n)
        mma(c[j][n], a[j].x, a[j].y, a[j].z, a[j].w, b0[n], b1[n]);
  }
  int32_t sum = 0;
#pragma unroll
  for (int j = 0; j < FUSED_TILES; ++j)
#pragma unroll
    for (int n = 0; n < FUSED_NT; ++n) sum += c[j][n][0] + c[j][n][1] + c[j][n][2] + c[j][n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

constexpr int TILE_NT = 4;         // n8 tiles per warp in hamming_mxu.cu

template <int EXPAND>
__global__ void tile_rate_kernel(int32_t* out, int iters) {
  __shared__ uint4 s_a[16 * 32];
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const uint32_t s = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  for (int i = threadIdx.x; i < 16 * 32; i += blockDim.x)
    s_a[i] = make_uint4(s, s ^ 5u, s + 7u, s * 3u);
  __syncthreads();
  int32_t c[2][TILE_NT][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < TILE_NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[h][n][i] = 0;
  uint32_t w[TILE_NT] = {s, s * 7u, s ^ 0x55u, s + 99u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < TILE_NT; ++n) w[n] = w[n] * 1664525u + 1013904223u;
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const uint4 a = s_a[m * 32 + lane];
#pragma unroll
      for (int n = 0; n < TILE_NT; ++n) {
        const uint32_t x = w[n] ^ (0x9E3779B9u * (m + 1));   // a word per MMA
        uint32_t b0, b1;
        if constexpr (EXPAND == 3) {
          b0 = x & (0x01010101u << (m & 3));
          b1 = x & (0x01010101u << (4 + (m & 3)));
        } else {
          b0 = b_operand<EXPAND>(x, t, 0);
          b1 = b_operand<EXPAND>(x, t, 1);
        }
        mma(c[m & 1][n], a.x, a.y, a.z, a.w, b0, b1);
      }
    }
  }
  int32_t sum = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < TILE_NT; ++n) sum += c[h][n][0] + c[h][n][1] + c[h][n][2] + c[h][n][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

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

// FUSED_TILES * FUSED_NT MMAs per warp and iteration, 256 threads a CTA.
extern "C" int probe_fused_rate(void* out, int blocks, int iters, int expand, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  switch (expand) {
    case 1: fused_rate_kernel<1><<<blocks, 256, 0, st>>>(o, iters); break;
    case 2: fused_rate_kernel<2><<<blocks, 256, 0, st>>>(o, iters); break;
    case 3: fused_rate_kernel<3><<<blocks, 256, 0, st>>>(o, iters); break;
    default: fused_rate_kernel<0><<<blocks, 256, 0, st>>>(o, iters);
  }
  return static_cast<int>(cudaGetLastError());
}

// 16 * TILE_NT MMAs per warp and iteration, 256 threads a CTA.
extern "C" int probe_tile_rate(void* out, int blocks, int iters, int expand, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  switch (expand) {
    case 1: tile_rate_kernel<1><<<blocks, 256, 0, st>>>(o, iters); break;
    case 2: tile_rate_kernel<2><<<blocks, 256, 0, st>>>(o, iters); break;
    case 3: tile_rate_kernel<3><<<blocks, 256, 0, st>>>(o, iters); break;
    default: tile_rate_kernel<0><<<blocks, 256, 0, st>>>(o, iters);
  }
  return static_cast<int>(cudaGetLastError());
}
