// Fused dual-window top-k OMS search on the int8 tensor cores for Hopper
// (sm_90a) — paper §II-C, MXU formulation.
//
// Replaces the Pallas TPU kernel repro/kernels/hamming_mxu/hamming_mxu.py
// (fused_search_mxu_kernel, launched by fused_search_mxu_pallas): backend
// fused_mxu. Same outputs as fused_search.cu, bit for bit: the Hamming
// tile comes from the +-1 int8 dot, sim = dim - (dim - dot) / 2 with
// dim = 32 * W, and dot is exact integer arithmetic.
//
// What bounds it on this card: operations. The +-1 dot of the main-path
// batch is 2.3e9 m16n8k32 MMAs (one packed word each, pm1_mma.cuh): at
// 0.586 per clock per SM (scripts/bmma_probe.py on an NVIDIA H100 80GB
// HBM3, 700.00 W) ~15 ms. Each operand register is the +-1 expansion of a
// nibble (four integer instructions), so the unpack must be shared by many
// MMAs or it costs more than the MMAs themselves: a kernel that unpacks each
// row for one 16-query tile spends as much on the unpack as the popc route
// on its popcounts.
//
// Design: the grouped search of ../../csrc/fused_grouped.cuh (GROUP = 8
// consecutive query tiles per CTA, rows streamed through shared memory,
// accumulators in registers, epilogue on the C fragments); this file
// supplies its MMA step. The queries stay packed in shared memory (512
// bytes of A fragments per word and tile would not fit for 8 tiles); the
// CTA expands them slice by slice (SW = 8 words) into A fragments that all
// 8 warps read, so each query word is expanded once per CTA pass of 256
// rows, not once per warp. Each lane expands the B fragments of its NT rows
// once per word and uses each on GROUP tiles.
#include <cstdint>
#include <cuda_runtime.h>

#include "../../csrc/fused_grouped.cuh"
#include "pm1_mma.cuh"

namespace {

struct Pm1Route {
  static constexpr bool kNorms = false;
  static constexpr int SW = 8;     // words per slice of expanded A fragments
  // One slice of A fragments: G tiles x SW words x 32 lanes x 16 bytes.
  static constexpr size_t scratch_bytes(int G) { return (size_t)G * SW * 32 * sizeof(uint4); }

  // One 16-word stage (words w0..w0 + 15 of the warp's 32 rows in `stage`,
  // row-major): c[gi][nt] += the +-1 dot of tile gi's queries g, g + 8 and
  // n-tile nt's rows over those words. Called by every thread of the CTA:
  // per slice of SW words the CTA expands the A fragments of all G tiles
  // into shared memory (entry (gi, j, lane) as pm1_mma.cuh lays out A).
  template <int G>
  __device__ static __forceinline__ void step(int32_t (&c)[G][NT][4], int (&)[NT],
                                              const uint32_t* s_q, int Wp, int swz,
                                              const uint32_t* stage, int w0, int W, int tid,
                                              void* scratch) {
    uint4* a_slice = static_cast<uint4*>(scratch);          // [G][SW][32]
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int t = lane & 3;
    for (int j0 = 0; j0 < STAGE_WORDS && w0 + j0 < W; j0 += SW) {
      __syncthreads();                          // the previous slice is read
      for (int i = tid; i < G * SW * 32; i += THREADS) {
        const int gi = i / (SW * 32);
        const int w = w0 + j0 + (i / 32) % SW;
        const int gg = (i & 31) >> 2;
        const int tt = i & 3;
        uint32_t lo = 0u, hi = 0u;
        if (w < W) {
          const int off = 4 * ((w >> 2) ^ ((gg & 1) ? swz : 0)) + (w & 3);
          lo = s_q[(size_t)(gi * QT + gg) * Wp + off];
          hi = s_q[(size_t)(gi * QT + gg + 8) * Wp + off];
        }
        a_slice[i] = make_uint4(pm1_nibble(lo, 4 * tt), pm1_nibble(hi, 4 * tt),
                                pm1_nibble(lo, 16 + 4 * tt), pm1_nibble(hi, 16 + 4 * tt));
      }
      __syncthreads();
#pragma unroll
      for (int j4 = 0; j4 < SW; j4 += 4) {
        // Four words of each of this lane's NT rows (the quad reads the same).
        uint4 rw[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          rw[nt] = *reinterpret_cast<const uint4*>(stage + (nt * 8 + g) * STAGE_WORDS + j0 + j4);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (w0 + j0 + j4 + j < W) {           // the same for the whole CTA
            uint32_t b0[NT], b1[NT];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint32_t word = j == 0 ? rw[nt].x : j == 1 ? rw[nt].y : j == 2 ? rw[nt].z : rw[nt].w;
              b0[nt] = pm1_nibble(word, 4 * t);
              b1[nt] = pm1_nibble(word, 16 + 4 * t);
            }
            // All G tiles' A fragments first: one shared-memory latency per
            // word, not one per tile.
            uint4 a[G];
#pragma unroll
            for (int gi = 0; gi < G; ++gi) a[gi] = a_slice[(gi * SW + j4 + j) * 32 + lane];
#pragma unroll
            for (int gi = 0; gi < G; ++gi)
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) mma_s8(c[gi][nt], a[gi], b0[nt], b1[nt]);
          }
        }
      }
    }
  }

  // sim = dim - (dim - dot) / 2; dim - dot is always even.
  __device__ static __forceinline__ int sim(int c, int, int, int dim) {
    return dim - ((dim - c) >> 1);
  }
};

}  // namespace

// The arguments of fused_search_launch (hamming/csrc/fused_search.cu);
// dim must be 32 * W. Any k >= 1 and W >= 1 (launch_grouped picks the
// lists' place and the query chunks). Launches both kernels on `stream`;
// returns cudaGetLastError().
extern "C" int fused_search_mxu_launch(
    const void* q, const void* q_pmz, const void* q_charge, const void* r,
    const void* r_pmz, const void* r_charge, const void* tile_start,
    void* partial, void* std_sim, void* std_row, void* open_sim,
    void* open_row, int n_tiles, int n_rows, int W, int dim, int k, int rk,
    int n_splits, float std_scale, float open_tol, float pad_pmz,
    void* stream) {
  if (dim != 32 * W) return static_cast<int>(cudaErrorInvalidValue);
  return launch_grouped<Pm1Route>(q, q_pmz, q_charge, r, r_pmz, r_charge, tile_start,
                                  partial, std_sim, std_row, open_sim, open_row, n_tiles,
                                  n_rows, W, dim, k, rk, n_splits, std_scale, open_tol,
                                  pad_pmz, static_cast<cudaStream_t>(stream));
}
