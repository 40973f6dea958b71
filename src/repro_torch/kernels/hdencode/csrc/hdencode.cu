// ID-Level HD spectrum encoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/hdencode/hdencode.py
// (hdencode_kernel, launched by hdencode_pallas): for each spectrum, bind
// ID[bin] ^ L[level] over its valid peaks, count every bit over the peaks,
// take the majority 2*count > n with the tie-break bit on 2*count == n, and
// pack the bits back into 32-bit words.
//
// What bounds it on this card: the function needs only ~3 integer
// operations per (valid peak, word) — an XOR to bind and a carry-save add
// into bit-sliced counters — so at the main-path shapes its least time is
// set by HBM (peaks in, HVs out, each touched codebook row once). This
// simple design counts bit by bit instead, ~3 operations per bit per valid
// peak, ~32x that work, so it is bound by the integer pipes; bit-sliced
// counters are the next step. The codebook gathers are served by L2: the
// whole ID codebook (36,000 bins x 512 B = 18.4 MB at dim 4096) fits in
// the 50 MB L2.
//
// Design: the Pallas kernel kept an (n_bins, word_tile) column slice of the
// ID codebook in VMEM (~1.15 MB at the defaults), five times the shared
// memory an H100 block can hold. Here nothing of the codebook is staged:
// one block encodes one spectrum, one thread owns one output word, and the
// spectrum's bins, levels and mask are staged in shared memory. For each
// peak the threads read id[bin*W + w] ^ lvl[level*W + w]; neighbouring
// threads read neighbouring words, so every gather is coalesced. The 32
// per-bit counters live in registers. The kernel makes no assumption on W:
// a block covers up to blockDim.x words and the grid's y axis covers the
// rest. A spectrum with no valid peak has n = 0, every bit ties, and the
// output is the tie-break HV.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void hdencode_kernel(const int32_t* __restrict__ bins,
                                const int32_t* __restrict__ levels,
                                const uint8_t* __restrict__ mask,
                                const uint32_t* __restrict__ id_hvs,
                                const uint32_t* __restrict__ level_hvs,
                                const uint32_t* __restrict__ tiebreak,
                                uint32_t* __restrict__ out, int P, int W) {
  extern __shared__ int32_t smem[];
  int32_t* s_bin = smem;          // (P,) peak bins, -1 where masked
  int32_t* s_lvl = smem + P;      // (P,) peak levels

  const int64_t b = blockIdx.x;
  const int w = blockIdx.y * blockDim.x + threadIdx.x;

  // Stage the spectrum's peaks; n = number of valid peaks. Every thread
  // runs the same number of rounds, so each __syncthreads_count (which
  // counts threads with a true predicate) sees the whole block.
  int n = 0;
  for (int base = 0; base < P; base += blockDim.x) {
    const int p = base + threadIdx.x;
    const bool m = p < P && mask[b * P + p] != 0;
    if (p < P) {
      s_bin[p] = m ? bins[b * P + p] : -1;
      s_lvl[p] = levels[b * P + p];
    }
    n += __syncthreads_count(m);
  }
  if (w >= W) return;

  int count[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) count[j] = 0;
  for (int p = 0; p < P; ++p) {
    const int bin = s_bin[p];     // the same for every thread: no divergence
    if (bin < 0) continue;
    const uint32_t x = __ldg(id_hvs + (int64_t)bin * W + w) ^
                       __ldg(level_hvs + (int64_t)s_lvl[p] * W + w);
#pragma unroll
    for (int j = 0; j < 32; ++j) count[j] += (x >> j) & 1u;
  }

  const uint32_t tie = tiebreak[w];
  uint32_t word = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int twice = 2 * count[j];
    const uint32_t bit = twice == n ? (tie >> j) & 1u : (twice > n ? 1u : 0u);
    word |= bit << j;
  }
  out[b * W + w] = word;
}

}  // namespace

// bins/levels (B, P) int32, mask (B, P) uint8 {0,1}, id_hvs (F, W),
// level_hvs (L, W), tiebreak (W,), out (B, W) — all packed words as 32-bit
// patterns. Launches on `stream`; returns cudaGetLastError().
extern "C" int hdencode_launch(const void* bins, const void* levels,
                               const void* mask, const void* id_hvs,
                               const void* level_hvs, const void* tiebreak,
                               void* out, int B, int P, int W, void* stream) {
  const int threads = W >= 128 ? 128 : ((W + 31) / 32) * 32;
  const dim3 grid(B, (W + threads - 1) / threads);
  const size_t smem = 2 * sizeof(int32_t) * (size_t)(P > 0 ? P : 1);
  hdencode_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bins), static_cast<const int32_t*>(levels),
      static_cast<const uint8_t*>(mask), static_cast<const uint32_t*>(id_hvs),
      static_cast<const uint32_t*>(level_hvs),
      static_cast<const uint32_t*>(tiebreak), static_cast<uint32_t*>(out), P,
      W);
  return static_cast<int>(cudaGetLastError());
}
