// Dual-window running top-k winners shared by the fused search kernels
// (hamming/csrc/fused_search.cu, hamming_mxu/csrc/fused_search_mxu.cu).
//
// Ranking uses the composite key (sim << 32) | (0xFFFFFFFF - row): a total
// order over distinct rows that agrees with (sim desc, row asc), so any
// reduction or merge order gives the TPU's sequential answer. 0 marks an
// empty slot (a real key has row < 2**31, so its low word is >= 2**31).
//
// A CTA keeps one descending list of k keys per (query, window) in shared
// memory, which all its warps insert into with insert_atomic. At the end of
// the CTA each list is its partial result for its split, and
// fused_search_merge merges the splits and decodes the keys. The shared
// lists take any k (their length is a launch argument); the merge keeps
// its list in registers and local memory, so it is instantiated for
// KCAP = 16, 32 and 64 and launch_merge picks the least KCAP >= k: KMAX =
// 64 is the launch limit, and k <= 16 runs the same merge as before.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 16;            // queries per tile
constexpr int NLISTS = 2 * QT;    // (query, window) winner lists per tile
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int KMAX = 64;          // the largest k a launch takes
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long winner_t;

// Insert `key` into the descending list of length k; the caller has checked
// that key beats list[k-1]. Single-threaded.
__device__ __forceinline__ void insert_desc(winner_t* list, int k, winner_t key) {
  int i = k - 1;
  while (i > 0 && list[i - 1] < key) {
    list[i] = list[i - 1];
    --i;
  }
  list[i] = key;
}

// Insert `key` into a descending shared list of length k that other threads
// insert into at the same time. Each slot keeps the larger of its value and
// the key passing through (atomicMax) and the smaller goes on to the next
// slot, so every key visits slot i unless it stays in a slot above: once
// all insertions are done, slot i holds the (i+1)-th largest key. At any
// moment every slot above the one holding v holds a key >= v, so list[k-1]
// is a safe threshold: a key below it is not among the final k.
__device__ __forceinline__ void insert_atomic(winner_t* list, int k, winner_t key) {
  for (int i = 0; i < k && key; ++i) {
    const winner_t old = atomicMax(list + i, key);
    key = old < key ? old : key;
  }
}

// The sim of the k-th entry of a shared list, 0 while it is not full: a
// pair with a lower sim cannot enter it. Reads the key's high word.
__device__ __forceinline__ int list_threshold(const winner_t* list, int k) {
  return *(reinterpret_cast<const volatile int*>(list + k - 1) + 1);
}

// Merge the per-split partial winners of every (tile, list) and decode the
// keys into sims and global rows (-1/-1 for empty ranks); k <= KCAP.
template <int KCAP>
__global__ void fused_search_merge(const winner_t* __restrict__ partial,
                                   int n_tiles, int n_splits, int k,
                                   int32_t* std_sim, int32_t* std_row,
                                   int32_t* open_sim, int32_t* open_row) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_tiles * NLISTS) return;
  const int tile = g / NLISTS;
  const int l = g % NLISTS;
  winner_t best[KCAP];
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

template <int KCAP>
void launch_merge_k(const void* partial, int n_tiles, int n_splits, int k, void* std_sim,
                    void* std_row, void* open_sim, void* open_row, cudaStream_t stream) {
  const int merge_threads = 256;
  const long long merge_blocks = ((long long)n_tiles * NLISTS + merge_threads - 1) / merge_threads;
  fused_search_merge<KCAP><<<(unsigned)merge_blocks, merge_threads, 0, stream>>>(
      static_cast<const winner_t*>(partial), n_tiles, n_splits, k,
      static_cast<int32_t*>(std_sim), static_cast<int32_t*>(std_row),
      static_cast<int32_t*>(open_sim), static_cast<int32_t*>(open_row));
}

// Enqueue fused_search_merge (the least KCAP >= k) on `stream`; returns
// cudaGetLastError().
inline int launch_merge(const void* partial, int n_tiles, int n_splits, int k,
                        void* std_sim, void* std_row, void* open_sim,
                        void* open_row, cudaStream_t stream) {
  if (k <= 16)
    launch_merge_k<16>(partial, n_tiles, n_splits, k, std_sim, std_row, open_sim, open_row,
                       stream);
  else if (k <= 32)
    launch_merge_k<32>(partial, n_tiles, n_splits, k, std_sim, std_row, open_sim, open_row,
                       stream);
  else
    launch_merge_k<64>(partial, n_tiles, n_splits, k, std_sim, std_row, open_sim, open_row,
                       stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
