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
// What bounds it on this card: operations. At the main-path batch (1,001
// query blocks x 143,360 rows x 128 words) the Hamming tiles are 2.3e9
// pairs x 4,096 bits. The popc route (one __popc per pair-word, 16 per
// clock per SM) needs ~70 ms; the int8 tensor cores (a +-1 dot) ~9.5 ms;
// the binary tensor cores, mma.sync m16n8k256 .b1 AND-popc at 0.589 per
// clock per SM (scripts/bmma_probe.py on an NVIDIA H100 80GB HBM3,
// 700.00 W), ~1.9 ms, so the pairs go there, with
//   ham(q, r) = |q| + |r| - 2 * popc(q & r)
// (.xor.popc is emulated on this card, 6x slower). Below that sit the
// rows: each query block scans its own 143,360 rows, so a kernel that
// reads them per 16-query tile moves 73.5 GB through L2 a batch.
//
// Design: the grouped search of ../../csrc/fused_grouped.cuh, which serves
// GROUP = 8 consecutive query tiles per CTA from one load of each row,
// streams the rows through shared memory and keeps the accumulators in
// registers; this file supplies its MMA step (./bmma.cuh, the fragment map
// of hamming_matrix.cu): per 16-word stage a lane reads 16 bytes of each of
// its NT rows and two A chunks per tile from the staged queries, and runs
// 2 x GROUP x NT MMAs. |r| is summed from the same row words (one popc per
// lane-word, 1/16 of the popc route); |q| once per CTA from the staged
// queries.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../csrc/fused_grouped.cuh"
#include "bmma.cuh"

namespace {

struct BinaryRoute {
  static constexpr bool kNorms = true;
  static constexpr size_t scratch_bytes(int) { return 0; }

  // One 16-word stage (words w0..w0 + 15 of the warp's 32 rows in `stage`,
  // row-major, zeros past W): c[gi][nt] += popc(q & r) for tile gi's
  // queries g, g + 8 and n-tile nt's rows; rn[nt] += |row| over this lane's
  // four words of its row.
  template <int G>
  __device__ static __forceinline__ void step(int32_t (&c)[G][NT][4], int (&rn)[NT],
                                              const uint32_t* s_q, int Wp, int swz,
                                              const uint32_t* stage, int w0, int, int tid,
                                              void*) {
    const int g = (tid & 31) >> 2;
    const int t = tid & 3;
    const int qsw = (g & 1) ? swz : 0;          // rows g and g + 8 share parity
    uint4 rv[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      rv[nt] = *reinterpret_cast<const uint4*>(stage + (nt * 8 + g) * STAGE_WORDS + 4 * t);
      rn[nt] += __popc(rv[nt].x) + __popc(rv[nt].y) + __popc(rv[nt].z) + __popc(rv[nt].w);
    }
    const int u = ((w0 >> 2) + t) ^ qsw;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const uint4 a = *reinterpret_cast<const uint4*>(s_q + (size_t)(gi * QT + g) * Wp + 4 * u);
      const uint4 b =
          *reinterpret_cast<const uint4*>(s_q + (size_t)(gi * QT + g + 8) * Wp + 4 * u);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_and_popc(c[gi][nt], a.x, b.x, a.y, b.y, rv[nt].x, rv[nt].y);
        mma_and_popc(c[gi][nt], a.z, b.z, a.w, b.w, rv[nt].z, rv[nt].w);
      }
    }
  }

  // sim = dim - (|q| + |r| - 2 popc(q & r)), dq = dim - |q|.
  __device__ static __forceinline__ int sim(int c, int dq, int rn, int) {
    return dq - rn + 2 * c;
  }
};

}  // namespace

// q (n_tiles*16, W), q_pmz/q_charge (n_tiles*16,), r (n_rows, W),
// r_pmz/r_charge (n_rows,), tile_start (n_tiles,) int32, partial
// (n_tiles, n_splits, 32, k) uint64 scratch ((n_tiles, 32, k) where the
// lists live in device memory, launch_grouped), outputs (n_tiles*16, k)
// int32. Any k >= 1 and W >= 1. Tile t scans rows [tile_start[t],
// tile_start[t] + rk); n_splits CTAs share each group's rows. Launches the
// search and the merge (or decode) on `stream`; returns
// cudaGetLastError().
extern "C" int fused_search_launch(
    const void* q, const void* q_pmz, const void* q_charge, const void* r,
    const void* r_pmz, const void* r_charge, const void* tile_start,
    void* partial, void* std_sim, void* std_row, void* open_sim,
    void* open_row, int n_tiles, int n_rows, int W, int dim, int k, int rk,
    int n_splits, float std_scale, float open_tol, float pad_pmz,
    void* stream) {
  return launch_grouped<BinaryRoute>(q, q_pmz, q_charge, r, r_pmz, r_charge, tile_start,
                                     partial, std_sim, std_row, open_sim, open_row, n_tiles,
                                     n_rows, W, dim, k, rk, n_splits, std_scale, open_tol,
                                     pad_pmz, static_cast<cudaStream_t>(stream));
}
