// Fused dual-window top-k OMS search on the int8 tensor cores for Hopper
// (sm_90a) — paper §II-C, MXU formulation.
//
// Replaces the Pallas TPU kernel repro/kernels/hamming_mxu/hamming_mxu.py
// (fused_search_mxu_kernel, launched by fused_search_mxu_pallas): backend
// fused_mxu. Same outputs as fused_search.cu, bit for bit: the Hamming
// tile comes from the +-1 int8 dot, sim = dim - (dim - dot) / 2 with
// dim = 32 * W, and dot is exact integer arithmetic.
//
// What bounds it on this card: operations. The tensor-core work of the +-1
// dot (2 * dim ops per pair at 1,979 TOP/s) is the least time for the
// function, ~7x below the popc route. This simple kernel does not reach
// it: unpacking every reference row to 32 int8 per word costs integer
// instructions on the same order as the popc route's popcounts (pm1_mma.cuh
// unpacks four bytes per instruction group, once per row per tile).
//
// Design: the launch contract of fused_search.cu — all query blocks in one
// launch (a per-tile start row), the rows of each 16-query tile split
// across CTAs, a merge kernel, the composite key and the -2**30 charge of
// padded queries (../../csrc/winners.cuh). A CTA unpacks its 16 queries
// once into A fragments in shared memory (512 bytes per word: 64 KB at
// W = 128, W <= 256). Each warp then takes 32 consecutive rows at a time:
// it computes their 16 x 32 sim tile with one m16n8k32 MMA per (word, n8
// tile), stages it in the warp's own 2 KB of shared memory, and each lane
// reads back its row's 16 sims and runs the same window test and top-k
// offers as the popc kernel.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../csrc/winners.cuh"
#include "pm1_mma.cuh"

namespace {

constexpr int MXU_W_MAX = 256;                 // A fragments: 512 B per word
static_assert(MMA_NT * 8 == 32, "a warp's MMA rows are its 32 lanes' rows");

template <int VEC>
__global__ void __launch_bounds__(THREADS)
fused_search_mxu_partial(const uint32_t* __restrict__ q,
                         const float* __restrict__ q_pmz,
                         const int32_t* __restrict__ q_charge,
                         const uint32_t* __restrict__ r,
                         const float* __restrict__ r_pmz,
                         const int32_t* __restrict__ r_charge,
                         const int32_t* __restrict__ tile_start, int n_rows,
                         int W, int dim, int k, int rk, int chunk,
                         float std_scale, float open_tol, float pad_pmz,
                         winner_t* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* s_a = reinterpret_cast<uint4*>(smem_raw);                    // W*32
  int32_t* s_sim = reinterpret_cast<int32_t*>(s_a + (size_t)W * 32);  // NWARPS*QT*32
  winner_t* s_list = reinterpret_cast<winner_t*>(s_sim + NWARPS * QT * 32);
  __shared__ float s_qp[QT];
  __shared__ int32_t s_qc[QT];

  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;

  stage_a_fragments(s_a, q + (size_t)tile * QT * W, QT, W, 0, W, tid, THREADS);
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
  int32_t* sims = s_sim + warp * QT * 32;       // [query][lane's row]

  for (int base = begin + warp * 32; base < end; base += THREADS) {
    int32_t c[MMA_NT][4];
    const uint32_t* rows[MMA_NT];
#pragma unroll
    for (int nt = 0; nt < MMA_NT; ++nt) {
      const int local = base + nt * 8 + g;
      const int row = row0 + local;
      rows[nt] = local < end && row < n_rows ? r + (size_t)row * W : nullptr;
#pragma unroll
      for (int i = 0; i < 4; ++i) c[nt][i] = 0;
    }
    mma_pm1_rows<VEC>(c, s_a, rows, W, lane);
#pragma unroll
    for (int nt = 0; nt < MMA_NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * t + e;
        sims[g * 32 + col] = dim - ((dim - c[nt][e]) >> 1);
        sims[(g + 8) * 32 + col] = dim - ((dim - c[nt][2 + e]) >> 1);
      }
    }
    __syncwarp();

    const int local = base + lane;
    const int row = row0 + local;
    const bool active = local < end && row < n_rows;
    float rp = pad_pmz;
    int32_t rc = -1;
    if (active) {
      rp = __ldg(r_pmz + row);
      rc = __ldg(r_charge + row);
    }
    int sim[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) sim[i] = sims[i * 32 + lane];
    __syncwarp();                 // the next iteration overwrites the tile
    offer_row(lists, k, lane, sim, active, rp, rc, row, s_qp, s_qc, std_scale,
              open_tol, pad_pmz);
  }
  __syncthreads();
  merge_warp_lists(s_list,
                   partial + ((size_t)tile * gridDim.y + split) * NLISTS * k, k,
                   tid);
}

}  // namespace

// The arguments of fused_search_launch (hamming/csrc/fused_search.cu);
// dim must be 32 * W and W <= 256. Launches both kernels on `stream`;
// returns cudaGetLastError().
extern "C" int fused_search_mxu_launch(
    const void* q, const void* q_pmz, const void* q_charge, const void* r,
    const void* r_pmz, const void* r_charge, const void* tile_start,
    void* partial, void* std_sim, void* std_row, void* open_sim,
    void* open_row, int n_tiles, int n_rows, int W, int dim, int k, int rk,
    int n_splits, float std_scale, float open_tol, float pad_pmz,
    void* stream) {
  if (k < 1 || k > KMAX || n_splits < 1 || n_tiles < 1 || W < 1 ||
      W > MXU_W_MAX || dim != 32 * W)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunk = (rk + n_splits - 1) / n_splits;
  const size_t smem = sizeof(uint4) * 32 * W + sizeof(int32_t) * NWARPS * QT * 32 +
                      sizeof(winner_t) * NWARPS * NLISTS * k;
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  const dim3 grid(n_tiles, n_splits);
#define REPRO_LAUNCH_MXU_PARTIAL(V)                                            \
  do {                                                                         \
    if (smem > 48 * 1024) {                                                    \
      cudaError_t e = cudaFuncSetAttribute(                                    \
          fused_search_mxu_partial<V>,                                         \
          cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));\
      if (e != cudaSuccess) return static_cast<int>(e);                        \
    }                                                                          \
    fused_search_mxu_partial<V><<<grid, THREADS, smem, st>>>(                  \
        static_cast<const uint32_t*>(q), static_cast<const float*>(q_pmz),     \
        static_cast<const int32_t*>(q_charge), static_cast<const uint32_t*>(r),\
        static_cast<const float*>(r_pmz),                                      \
        static_cast<const int32_t*>(r_charge),                                 \
        static_cast<const int32_t*>(tile_start), n_rows, W, dim, k, rk, chunk, \
        std_scale, open_tol, pad_pmz, static_cast<winner_t*>(partial));       \
  } while (0)
  if (vec4)
    REPRO_LAUNCH_MXU_PARTIAL(4);
  else
    REPRO_LAUNCH_MXU_PARTIAL(1);
#undef REPRO_LAUNCH_MXU_PARTIAL
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_merge(partial, n_tiles, n_splits, k, std_sim, std_row,
                      open_sim, open_row, st);
}
