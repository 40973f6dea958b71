// All-pairs Hamming tile for Hopper (sm_90a): q (Q, W) x r (R, W) packed
// uint32 words -> out (Q, R) int32, out[i][j] = popcount(q[i] ^ r[j]).
//
// Replaces the Pallas TPU kernel repro/kernels/hamming/hamming.py
// (hamming_matrix_kernel, launched by hamming_matrix_pallas): backend
// kernel_vpu, and the prefix scan and survivor rescore of the dimension
// cascade for every matrix backend of that kind.
//
// What bounds it on this card: bytes. At the main-path tile (16 queries x
// 143,360 rows x 128 words) the reference rows (73.4 MB) and the output
// tile (9.2 MB) take ~25 us at 3.35 TB/s, while the +-1 int8 dot would need
// ~9.5 us of tensor-core work; this kernel takes the popc route (~70 us of
// __popc at 16 per clock per SM), so it is operation-bound in practice.
//
// Design: a CTA stages QT = 16 query rows in shared memory and gives each
// of its 256 threads one reference row, read 16 bytes at a time when W is a
// multiple of 4 (one word at a time otherwise: the prefix scan runs at
// W = prefix_words) and XOR-popcounted against every staged query in
// registers. out[q][r] is stored with r contiguous across the threads, so
// stores are coalesced. Any Q, R and W: the tails are bounds-checked, there
// is no padding contract.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 16;
constexpr int THREADS = 256;

template <int VEC>
__global__ void __launch_bounds__(THREADS)
hamming_matrix_kernel(const uint32_t* __restrict__ q,
                      const uint32_t* __restrict__ r, int32_t* __restrict__ out,
                      int Q, int R, int W) {
  extern __shared__ __align__(16) uint32_t s_q[];   // QT*W
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, Q - q0);
  const int tid = threadIdx.x;
  const uint32_t* qt = q + (size_t)q0 * W;
  for (int i = tid; i < QT * W; i += THREADS) s_q[i] = i < nq * W ? qt[i] : 0u;
  __syncthreads();

  const int row = blockIdx.x * THREADS + tid;
  if (row >= R) return;
  int acc[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) acc[i] = 0;
  const uint32_t* rr = r + (size_t)row * W;
  if (VEC == 4) {
    for (int w = 0; w < W; w += 4) {
      const uint4 rv = __ldg(reinterpret_cast<const uint4*>(rr + w));
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const uint4 qv = *reinterpret_cast<const uint4*>(s_q + i * W + w);
        acc[i] += __popc(rv.x ^ qv.x) + __popc(rv.y ^ qv.y) +
                  __popc(rv.z ^ qv.z) + __popc(rv.w ^ qv.w);
      }
    }
  } else {
    for (int w = 0; w < W; ++w) {
      const uint32_t rv = __ldg(rr + w);
#pragma unroll
      for (int i = 0; i < QT; ++i) acc[i] += __popc(rv ^ s_q[i * W + w]);
    }
  }
#pragma unroll
  for (int i = 0; i < QT; ++i)
    if (i < nq) out[(size_t)(q0 + i) * R + row] = acc[i];
}

}  // namespace

// q (Q, W), r (R, W) uint32, out (Q, R) int32, all contiguous on the
// device. Launches on `stream`; returns cudaGetLastError().
extern "C" int hamming_matrix_launch(const void* q, const void* r, void* out,
                                     int Q, int R, int W, void* stream) {
  if (Q < 1 || R < 1 || W < 1 || (Q + QT - 1) / QT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(uint32_t) * QT * W;
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid((R + THREADS - 1) / THREADS, (Q + QT - 1) / QT);
#define REPRO_LAUNCH_MATRIX(V)                                                 \
  do {                                                                         \
    if (smem > 48 * 1024) {                                                    \
      cudaError_t e = cudaFuncSetAttribute(                                    \
          hamming_matrix_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,\
          static_cast<int>(smem));                                             \
      if (e != cudaSuccess) return static_cast<int>(e);                        \
    }                                                                          \
    hamming_matrix_kernel<V><<<grid, THREADS, smem, st>>>(                     \
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),      \
        static_cast<int32_t*>(out), Q, R, W);                                  \
  } while (0)
  if (vec4)
    REPRO_LAUNCH_MATRIX(4);
  else
    REPRO_LAUNCH_MATRIX(1);
#undef REPRO_LAUNCH_MATRIX
  return static_cast<int>(cudaGetLastError());
}
