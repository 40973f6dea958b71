// Dual-window running top-k winners shared by the fused search kernels
// (hamming/csrc/fused_search.cu, hamming_mxu/csrc/fused_search_mxu.cu).
//
// Ranking uses the composite key (sim << 32) | (0xFFFFFFFF - row): a total
// order over distinct rows that agrees with (sim desc, row asc), so any
// reduction or merge order gives the TPU's sequential answer. 0 marks an
// empty slot. Each warp keeps its own top-k list per (query, window) in
// shared memory; a lane offers its key only when it beats the list's k-th
// entry (a ballot), so insertions become rare once the lists fill. At the
// end of a CTA the warps' lists are merged into one partial list per split,
// and fused_search_merge merges the splits and decodes the keys.
//
// Masks round exactly as the reference: std_scale = float32(ppm_tol *
// 1e-6) is rounded once on the host, and the products and differences use
// __fmul_rn/__fsub_rn so they are never contracted.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 16;            // queries per tile
constexpr int NLISTS = 2 * QT;    // (query, window) winner lists per tile
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int KMAX = 16;
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long winner_t;

// Insert `key` into the descending list of length k; the caller has checked
// that key beats list[k-1].
__device__ __forceinline__ void insert_desc(winner_t* list, int k, winner_t key) {
  int i = k - 1;
  while (i > 0 && list[i - 1] < key) {
    list[i] = list[i - 1];
    --i;
  }
  list[i] = key;
}

// Warp-cooperative offer of each lane's key to one shared list.
__device__ __forceinline__ void offer(winner_t* list, int k, winner_t key, int lane) {
  winner_t thr = list[k - 1];
  unsigned m = __ballot_sync(FULL, key > thr);
  while (m) {
    const int src = __ffs(m) - 1;
    const winner_t cand = __shfl_sync(FULL, key, src);
    if (lane == 0) insert_desc(list, k, cand);
    __syncwarp();
    if (lane == src) key = 0ull;
    thr = list[k - 1];
    m = __ballot_sync(FULL, key > thr);
  }
}

// One reference row per lane against the tile's QT queries: apply charge
// and PAD validity and both windows to sim[i] = dim - hamming, and offer
// the row's keys to the warp's 2*QT lists. All 32 lanes must call it.
__device__ __forceinline__ void offer_row(winner_t* lists, int k, int lane,
                                          const int (&sim)[QT], bool active,
                                          float rp, int32_t rc, int row,
                                          const float* s_qp, const int32_t* s_qc,
                                          float std_scale, float open_tol,
                                          float pad_pmz) {
  const bool rvalid = active && rp < pad_pmz;
  const winner_t row_key = 0xFFFFFFFFull - (uint32_t)row;
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const float qp = s_qp[i];
    const bool valid = rvalid && s_qc[i] == rc && sim[i] >= 0;
    const float d = fabsf(__fsub_rn(qp, rp));
    const winner_t key = ((winner_t)(uint32_t)sim[i] << 32) | row_key;
    const winner_t ks = (valid && d <= __fmul_rn(qp, std_scale)) ? key : 0ull;
    const winner_t ko = (valid && d <= open_tol) ? key : 0ull;
    offer(lists + (size_t)(2 * i) * k, k, ks, lane);
    offer(lists + (size_t)(2 * i + 1) * k, k, ko, lane);
  }
}

// Merge the NWARPS per-warp lists of a CTA (s_list, NWARPS x NLISTS x k)
// into its partial slot out (NLISTS x k): one thread per (query, window).
__device__ __forceinline__ void merge_warp_lists(const winner_t* s_list,
                                                 winner_t* out, int k, int tid) {
  if (tid < NLISTS) {
    winner_t best[KMAX];
    for (int i = 0; i < k; ++i) best[i] = 0ull;
    for (int wv = 0; wv < NWARPS; ++wv) {
      const winner_t* src = s_list + ((size_t)wv * NLISTS + tid) * k;
      for (int i = 0; i < k; ++i) {
        if (src[i] <= best[k - 1]) break;     // src is descending
        insert_desc(best, k, src[i]);
      }
    }
    for (int i = 0; i < k; ++i) out[(size_t)tid * k + i] = best[i];
  }
}

// Merge the per-split partial winners of every (tile, list) and decode the
// keys into sims and global rows (-1/-1 for empty ranks).
__global__ void fused_search_merge(const winner_t* __restrict__ partial,
                                   int n_tiles, int n_splits, int k,
                                   int32_t* std_sim, int32_t* std_row,
                                   int32_t* open_sim, int32_t* open_row) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_tiles * NLISTS) return;
  const int tile = g / NLISTS;
  const int l = g % NLISTS;
  winner_t best[KMAX];
  for (int i = 0; i < k; ++i) best[i] = 0ull;
  for (int s = 0; s < n_splits; ++s) {
    const winner_t* src = partial + (((size_t)tile * n_splits + s) * NLISTS + l) * k;
    for (int i = 0; i < k; ++i) {
      if (src[i] <= best[k - 1]) break;
      insert_desc(best, k, src[i]);
    }
  }
  const size_t qrow = (size_t)tile * QT + l / 2;
  int32_t* sim_out = (l & 1) ? open_sim : std_sim;
  int32_t* row_out = (l & 1) ? open_row : std_row;
  for (int i = 0; i < k; ++i) {
    const winner_t key = best[i];
    sim_out[qrow * k + i] = key ? (int32_t)(key >> 32) : -1;
    row_out[qrow * k + i] =
        key ? (int32_t)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull)) : -1;
  }
}

// Enqueue fused_search_merge on `stream`; returns cudaGetLastError().
inline int launch_merge(const void* partial, int n_tiles, int n_splits, int k,
                        void* std_sim, void* std_row, void* open_sim,
                        void* open_row, cudaStream_t stream) {
  const int merge_threads = 256;
  const int merge_blocks = (n_tiles * NLISTS + merge_threads - 1) / merge_threads;
  fused_search_merge<<<merge_blocks, merge_threads, 0, stream>>>(
      static_cast<const winner_t*>(partial), n_tiles, n_splits, k,
      static_cast<int32_t*>(std_sim), static_cast<int32_t*>(std_row),
      static_cast<int32_t*>(open_sim), static_cast<int32_t*>(open_row));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
