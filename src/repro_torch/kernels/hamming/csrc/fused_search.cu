// Fused dual-window top-k OMS search for Hopper (sm_90a) — paper §II-C.
//
// Replaces the Pallas TPU kernel repro/kernels/hamming/hamming.py
// (fused_search_kernel, launched by fused_search_pallas). For every
// (query, reference row) pair: sim = dim - popcount(q ^ r); the pair is
// valid when r_pmz < PAD_PMZ and the charges match; the standard window is
// |dpmz| <= q_pmz * ppm_tol * 1e-6 and the open window |dpmz| <= open_tol.
// Each window keeps the k best rows ranked by (sim desc, row asc); empty
// ranks are -1/-1.
//
// What bounds it on this card: operations, not HBM — every row word is
// reused by the 16 queries of a tile. The least time for the function is on
// the int8 tensor cores (a +-1 dot gives the Hamming tile at 2*dim ops per
// pair). This kernel takes the popc route instead, and __popc issues at a
// quarter of the 32-bit add/xor rate (16 per clock per SM on compute
// capability 9.0), about 7x slower than the tensor-core bound at the
// main-path shapes; the int8 formulation is
// ../../hamming_mxu/csrc/fused_search_mxu.cu.
//
// Design:
//  * One launch covers every query block of the batch. The reference calls
//    its kernel once per 16-query block inside lax.map, each on the
//    k_blocks*max_r rows from that block's start row; here a per-tile
//    start-row vector comes in from the caller and rows stay global
//    (start_row + column).
//  * The TPU kernel accumulates winners in its output block because its
//    last grid axis runs in order. CUDA blocks run in no order, so each
//    query tile's rows are split across several CTAs (enough to fill the
//    132 SMs even for a few tiles) and a second kernel merges the per-split
//    partial winners.
//  * A CTA keeps its 16 queries in shared memory (8 KB at dim 4096). Each
//    thread takes one reference row at a time, reads it with 16-byte loads
//    and accumulates __popc(q ^ r) for all 16 queries in registers.
//  * Ranking, the per-warp winner lists, their merges and the exact mask
//    rounding are shared with fused_search_mxu.cu (../../csrc/winners.cuh).
#include <cstdint>
#include <cuda_runtime.h>

#include "../../csrc/winners.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(THREADS)
fused_search_partial(const uint32_t* __restrict__ q,
                     const float* __restrict__ q_pmz,
                     const int32_t* __restrict__ q_charge,
                     const uint32_t* __restrict__ r,
                     const float* __restrict__ r_pmz,
                     const int32_t* __restrict__ r_charge,
                     const int32_t* __restrict__ tile_start, int n_rows, int W,
                     int dim, int k, int rk, int chunk, float std_scale,
                     float open_tol, float pad_pmz, winner_t* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* s_q = reinterpret_cast<uint32_t*>(smem_raw);             // QT*W
  winner_t* s_list = reinterpret_cast<winner_t*>(smem_raw + sizeof(uint32_t) * QT * W);
  __shared__ float s_qp[QT];
  __shared__ int32_t s_qc[QT];

  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const uint32_t* qt = q + (size_t)tile * QT * W;
  for (int i = tid; i < QT * W; i += THREADS) s_q[i] = qt[i];
  if (tid < QT) {
    s_qp[tid] = q_pmz[tile * QT + tid];
    s_qc[tid] = q_charge[tile * QT + tid];
  }
  for (int i = tid; i < NWARPS * NLISTS * k; i += THREADS) s_list[i] = 0ull;
  __syncthreads();

  const int row0 = tile_start[tile];
  const int begin = split * chunk;
  const int end = min(begin + chunk, rk);
  winner_t* lists = s_list + (size_t)warp * NLISTS * k;

  for (int base = begin + warp * 32; base < end; base += THREADS) {
    const int local = base + lane;
    const int row = row0 + local;
    const bool active = local < end && row < n_rows;
    int acc[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) acc[i] = 0;
    float rp = pad_pmz;
    int32_t rc = -1;
    if (active) {
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
      rp = __ldg(r_pmz + row);
      rc = __ldg(r_charge + row);
    }
    int sim[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) sim[i] = dim - acc[i];
    offer_row(lists, k, lane, sim, active, rp, rc, row, s_qp, s_qc, std_scale,
              open_tol, pad_pmz);
  }
  __syncthreads();
  merge_warp_lists(s_list,
                   partial + ((size_t)tile * gridDim.y + split) * NLISTS * k, k,
                   tid);
}

}  // namespace

// q (n_tiles*16, W), q_pmz/q_charge (n_tiles*16,), r (n_rows, W),
// r_pmz/r_charge (n_rows,), tile_start (n_tiles,) int32, partial
// (n_tiles, n_splits, 32, k) uint64 scratch, outputs (n_tiles*16, k) int32.
// Tile t scans rows [tile_start[t], tile_start[t] + rk). Launches both
// kernels on `stream`; returns cudaGetLastError().
extern "C" int fused_search_launch(
    const void* q, const void* q_pmz, const void* q_charge, const void* r,
    const void* r_pmz, const void* r_charge, const void* tile_start,
    void* partial, void* std_sim, void* std_row, void* open_sim,
    void* open_row, int n_tiles, int n_rows, int W, int dim, int k, int rk,
    int n_splits, float std_scale, float open_tol, float pad_pmz,
    void* stream) {
  if (k < 1 || k > KMAX || n_splits < 1 || n_tiles < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = (rk + n_splits - 1) / n_splits;
  const size_t smem = sizeof(uint32_t) * QT * W + sizeof(winner_t) * NWARPS * NLISTS * k;
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const dim3 grid(n_tiles, n_splits);
#define REPRO_LAUNCH_PARTIAL(V)                                                 \
  do {                                                                          \
    if (smem > 48 * 1024) {                                                     \
      cudaError_t e = cudaFuncSetAttribute(                                     \
          fused_search_partial<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          static_cast<int>(smem));                                              \
      if (e != cudaSuccess) return static_cast<int>(e);                         \
    }                                                                           \
    fused_search_partial<V><<<grid, THREADS, smem, st>>>(                       \
        static_cast<const uint32_t*>(q), static_cast<const float*>(q_pmz),      \
        static_cast<const int32_t*>(q_charge), static_cast<const uint32_t*>(r), \
        static_cast<const float*>(r_pmz), static_cast<const int32_t*>(r_charge),\
        static_cast<const int32_t*>(tile_start), n_rows, W, dim, k, rk, chunk,  \
        std_scale, open_tol, pad_pmz, static_cast<winner_t*>(partial));            \
  } while (0)
  if (vec4)
    REPRO_LAUNCH_PARTIAL(4);
  else
    REPRO_LAUNCH_PARTIAL(1);
#undef REPRO_LAUNCH_PARTIAL
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge(partial, n_tiles, n_splits, k, std_sim, std_row,
                      open_sim, open_row, st);
}
