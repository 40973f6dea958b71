// All-pairs Hamming tile on the int8 tensor cores for Hopper (sm_90a):
// q (Q, W) x r (R, W) packed uint32 words -> out (Q, R) int32,
// out = (dim - dot) >> 1 with dot the +-1 product over dim = 32 * W bits.
//
// Replaces the Pallas TPU kernel repro/kernels/hamming_mxu/hamming_mxu.py
// (hamming_mxu_kernel, launched by hamming_matrix_mxu_pallas): backend
// kernel_mxu, and the prefix scan and survivor rescore of the dimension
// cascade for kernel_mxu and fused_mxu.
//
// What bounds it on this card: bytes. At the main-path tile (16 queries x
// 143,360 rows x 128 words) the reference rows (73.4 MB) and the output
// tile (9.2 MB) take ~25 us at 3.35 TB/s; the tensor-core work is ~9.5 us.
// The unpack of every reference row to 32 int8 per word costs integer
// instructions on the same order as the popc route's popcounts, so this
// simple kernel is instruction-bound, not tensor-core-bound.
//
// Design (see pm1_mma.cuh for the fragment layout): a CTA takes QT = 16
// queries and 256 reference rows; each of its 8 warps owns 32 rows (four
// n8 tiles). The queries are unpacked once per word chunk into A fragments
// in shared memory (KW = 64 words, 32 KB); each lane unpacks its own B
// registers straight from 16-byte row loads (word loads when W % 4 != 0)
// and runs one m16n8k32 MMA per (word, n8 tile). The epilogue writes
// (dim - dot) >> 1, exact because dim - dot is always even. Any Q, R and
// W: rows and queries past the end read as zeros and are not stored.
#include <cstdint>
#include <cuda_runtime.h>

#include "pm1_mma.cuh"

namespace {

constexpr int QT = 16;
constexpr int THREADS = 256;
constexpr int ROWS_PER_CTA = THREADS / 32 * MMA_NT * 8;   // 256
constexpr int KW = 64;                                    // words per A chunk

template <int VEC>
__global__ void __launch_bounds__(THREADS)
hamming_mxu_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
                   int32_t* __restrict__ out, int Q, int R, int W, int dim) {
  __shared__ uint4 s_a[KW * 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, Q - q0);
  const int rbase = blockIdx.x * ROWS_PER_CTA + warp * (MMA_NT * 8);

  int32_t c[MMA_NT][4];
#pragma unroll
  for (int nt = 0; nt < MMA_NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] = 0;

  for (int w0 = 0; w0 < W; w0 += KW) {
    const int nw = min(KW, W - w0);
    __syncthreads();                       // the previous chunk is consumed
    stage_a_fragments(s_a, q + (size_t)q0 * W, nq, W, w0, nw, tid, THREADS);
    __syncthreads();
    const uint32_t* rows[MMA_NT];
#pragma unroll
    for (int nt = 0; nt < MMA_NT; ++nt) {
      const int row = rbase + nt * 8 + g;
      rows[nt] = row < R ? r + (size_t)row * W + w0 : nullptr;
    }
    mma_pm1_rows<VEC>(c, s_a, rows, nw, lane);
  }

#pragma unroll
  for (int nt = 0; nt < MMA_NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = rbase + nt * 8 + 2 * t + e;
      if (col >= R) continue;
      if (g < nq) out[(size_t)(q0 + g) * R + col] = (dim - c[nt][e]) >> 1;
      if (g + 8 < nq) out[(size_t)(q0 + g + 8) * R + col] = (dim - c[nt][2 + e]) >> 1;
    }
  }
}

}  // namespace

// q (Q, W), r (R, W) uint32, out (Q, R) int32, all contiguous on the
// device; dim must be 32 * W. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int hamming_mxu_launch(const void* q, const void* r, void* out, int Q,
                                  int R, int W, int dim, void* stream) {
  if (Q < 1 || R < 1 || W < 1 || dim != 32 * W || (Q + QT - 1) / QT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  const dim3 grid((R + ROWS_PER_CTA - 1) / ROWS_PER_CTA, (Q + QT - 1) / QT);
  if (vec4)
    hamming_mxu_kernel<4><<<grid, THREADS, 0, st>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
        static_cast<int32_t*>(out), Q, R, W, dim);
  else
    hamming_mxu_kernel<1><<<grid, THREADS, 0, st>>>(
        static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
        static_cast<int32_t*>(out), Q, R, W, dim);
  return static_cast<int>(cudaGetLastError());
}
