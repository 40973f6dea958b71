// Dual-window running top-k winners shared by the fused search kernels
// (hamming/csrc/fused_search.cu, hamming_mxu/csrc/fused_search_mxu.cu).
//
// Ranking uses the composite key (sim << 32) | (0xFFFFFFFF - row): a total
// order over distinct rows that agrees with (sim desc, row asc), so any
// reduction or merge order gives the TPU's sequential answer. 0 marks an
// empty slot (a real key has row < 2**31, so its low word is >= 2**31).
//
// Where k <= KSHARED and a tile's lists fit, a CTA keeps one descending
// list of k keys per (query, window) in shared memory, which all its warps
// insert into with insert_atomic. At the end of the CTA each list is its
// partial result for its split, and fused_search_merge merges the splits
// and decodes the keys. The merge keeps its list in registers and local
// memory, so it is instantiated for KCAP = 16, 32 and 64 and launch_merge
// picks the least KCAP >= k; k <= 16 runs the same merge as before.
//
// Otherwise (any larger k, or rows too wide for the shared lists) the lists
// live in device memory, one per (tile, list) for all the splits of its
// group: every CTA inserts into them with insert_atomic_from, so the chains
// themselves merge the splits, and fused_search_decode only decodes.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int QT = 16;            // queries per tile
constexpr int NLISTS = 2 * QT;    // (query, window) winner lists per tile
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int KSHARED = 64;       // the largest k of the shared lists
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

// insert_atomic into a list in device memory, shared by CTAs on other SMs.
// A slot only grows (atomicMax), so a slot read above the key stays above
// it and the chain would pass it unchanged: the walk starts below the slots
// that a binary search reads above the key, after O(log k) reads instead of
// a walk down from slot 0. Stale reads are only lower, so they can only
// start the walk higher.
__device__ __forceinline__ void insert_atomic_from(winner_t* list, int k, winner_t key) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (*reinterpret_cast<const volatile winner_t*>(list + mid) > key)
      lo = mid + 1;
    else
      hi = mid;
  }
  insert_atomic(list + lo, k - lo, key);
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

// Decode the device-memory lists (n_tiles, NLISTS, k) into sims and global
// rows (-1/-1 for empty ranks).
__global__ void fused_search_decode(const winner_t* __restrict__ lists, long long n, int k,
                                    int32_t* std_sim, int32_t* std_row, int32_t* open_sim,
                                    int32_t* open_row) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long tl = i / k;               // tile * NLISTS + list
    const int l = (int)(tl % NLISTS);
    const long long out = (tl / NLISTS * QT + l / 2) * k + (i - tl * k);
    const winner_t key = lists[i];
    ((l & 1) ? open_sim : std_sim)[out] = key ? (int32_t)(key >> 32) : -1;
    ((l & 1) ? open_row : std_row)[out] =
        key ? (int32_t)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull)) : -1;
  }
}

// Enqueue fused_search_decode over n_tiles tiles on `stream`; returns
// cudaGetLastError().
inline int launch_decode(const void* lists, int n_tiles, int k, void* std_sim, void* std_row,
                         void* open_sim, void* open_row, cudaStream_t stream) {
  const long long n = (long long)n_tiles * NLISTS * k;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  fused_search_decode<<<(unsigned)(blocks < 65536 ? blocks : 65536), threads, 0, stream>>>(
      static_cast<const winner_t*>(lists), n, k, static_cast<int32_t*>(std_sim),
      static_cast<int32_t*>(std_row), static_cast<int32_t*>(open_sim),
      static_cast<int32_t*>(open_row));
  return static_cast<int>(cudaGetLastError());
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
