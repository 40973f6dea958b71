// ID-Level HD spectrum encoder for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/hdencode/hdencode.py
// (hdencode_kernel, launched by hdencode_pallas): for each spectrum, bind
// ID[bin] ^ L[level] over its valid peaks, count every bit over the peaks,
// take the majority 2*count > n with the tie-break bit on 2*count == n, and
// pack the bits back into 32-bit words.
//
// What bounds it on this card: the function needs ~4 integer operations
// per (valid peak, word) — an XOR to bind and a carry-save add into
// bit-sliced counters — so its least time is set by HBM (peaks in, HVs
// out, each touched codebook row once). What stops this kernel is the
// gather: every valid peak reads one ID-codebook row (512 B at dim 4096)
// and one level row. The ID codebook (36,000 bins x 512 B = 18.4 MB at
// dim 4096) fits in the 50 MB L2, so the gathers are served by L2; the
// 32 level rows (16 KB) fit in L1. At 4,096 spectra x 64 peaks the
// gathered rows (185 MB) stream at ~5.1 TB/s (chip_smoke.py on an NVIDIA
// H100 80GB HBM3, 700.00 W).
//
// Design: one warp encodes one spectrum (WARPS spectra per CTA); lane l
// owns VEC consecutive words (16-byte loads when W % 4 == 0 and the
// codebooks are 16-byte aligned, one word otherwise) and the warp loops
// over word chunks of 32 * VEC. The warp walks the peaks 32 at a time:
// a ballot of the mask compacts the valid (bin, level) pairs into a ring
// in shared memory, so masked peaks cost no gather and every branch is
// uniform across the warp. Bound words x = ID[bin][w] ^ L[level][w] are
// summed bit-sliced, Harley-Seal style: eight peaks at a time go through
// seven full adders (two LOP3 each) into the planes ones, twos, fours, and
// the group's eights carry ripples into NU upper planes. The count of bit
// j is then the binary number (..., u1, u0, fours, twos, ones) at bit j,
// and NU = bit_length(P >> 3) planes hold P without overflow. The
// majority compares that count with h = n >> 1 plane by plane from the
// top: count > h sets the bit, count == h takes the tie-break bit when n
// is even (2 * count == n). A spectrum with no valid peak has n = 0,
// every count equals h = 0, and the output is the tie-break HV. The last
// group of a spectrum is padded with zero words, which add nothing.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;          // spectra per CTA, one warp each
constexpr int GROUP = 8;          // peaks per carry-save group
constexpr int RING = 64;          // compacted peaks per warp (>= GROUP - 1 + 32)
constexpr int NU_GENERAL = 28;    // upper planes for any int P (P >> 3 < 2^28)

template <int VEC>
__device__ __forceinline__ void load_words(uint32_t (&v)[VEC], const uint32_t* p) {
  if constexpr (VEC == 4) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Full adder on bit planes: a + b + c = sum + 2 * carry, bit by bit.
__device__ __forceinline__ void csa(uint32_t& carry, uint32_t& sum, uint32_t a,
                                    uint32_t b, uint32_t c) {
  sum = a ^ b ^ c;
  carry = (a & b) | (a & c) | (b & c);
}

template <int VEC, int NU>
struct Planes {
  uint32_t ones[VEC], twos[VEC], fours[VEC];
  uint32_t up[NU > 0 ? NU : 1][VEC];   // bits 3, 4, ... of every count

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      ones[v] = twos[v] = fours[v] = 0u;
#pragma unroll
      for (int j = 0; j < (NU > 0 ? NU : 1); ++j) up[j][v] = 0u;
    }
  }

  // Adds eight bound words x[0..7] (per owned word v) into the planes.
  __device__ __forceinline__ void add8(const uint32_t (&x)[GROUP][VEC]) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      uint32_t twos_a, twos_b, fours_a, fours_b, eights;
      csa(twos_a, ones[v], ones[v], x[0][v], x[1][v]);
      csa(twos_b, ones[v], ones[v], x[2][v], x[3][v]);
      csa(fours_a, twos[v], twos[v], twos_a, twos_b);
      csa(twos_a, ones[v], ones[v], x[4][v], x[5][v]);
      csa(twos_b, ones[v], ones[v], x[6][v], x[7][v]);
      csa(fours_b, twos[v], twos[v], twos_a, twos_b);
      csa(eights, fours[v], fours[v], fours_a, fours_b);
      // Ripple the eights into the upper planes; the carry out of the top
      // plane is always 0 because every count is at most P < 2^(3 + NU).
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        const uint32_t c = up[j][v] & eights;
        up[j][v] ^= eights;
        eights = c;
      }
    }
  }

  // Bit j of the result: count_j > h, or count_j == h and tie_j when
  // `even` (~0 when n is even, 0 when it is odd). h < 2^(3 + NU).
  __device__ __forceinline__ uint32_t majority(int v, uint32_t h, uint32_t tie,
                                               uint32_t even) const {
    uint32_t gt = 0u, eq = ~0u;
#pragma unroll
    for (int j = 3 + NU - 1; j >= 0; --j) {
      const uint32_t c = j == 0 ? ones[v] : j == 1 ? twos[v] : j == 2 ? fours[v]
                                                                     : up[j - 3][v];
      if ((h >> j) & 1u) {
        eq &= c;
      } else {
        gt |= eq & c;
        eq &= ~c;
      }
    }
    return gt | (eq & tie & even);
  }
};

template <int VEC, int NU>
__global__ void __launch_bounds__(WARPS * 32)
hdencode_kernel(const int32_t* __restrict__ bins, const int32_t* __restrict__ levels,
                const uint8_t* __restrict__ mask, const uint32_t* __restrict__ id_hvs,
                const uint32_t* __restrict__ level_hvs,
                const uint32_t* __restrict__ tiebreak, uint32_t* __restrict__ out,
                int B, int P, int W) {
  __shared__ int2 s_ring[WARPS][RING];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * WARPS + warp;
  if (b >= B) return;                    // the whole warp leaves together
  int2* ring = s_ring[warp];
  const int64_t row0 = b * P;
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int64_t w0 = (int64_t)blockIdx.y * 32 * VEC; w0 < W;
       w0 += (int64_t)gridDim.y * 32 * VEC) {
    const int64_t w = w0 + lane * VEC;
    const bool active = w < W;           // VEC == 4 implies W % 4 == 0
    Planes<VEC, NU> cnt;
    cnt.clear();

    // Gathers and binds peaks ring[head .. head + n_peaks) (n_peaks <= 8;
    // the rest of the group reads as zero words) and adds them.
    auto add_group = [&](int head, int n_peaks) {
      uint32_t x[GROUP][VEC];
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        if (active && k < n_peaks) {
          const int2 pk = ring[(head + k) % RING];
          uint32_t id[VEC], lv[VEC];
          load_words<VEC>(id, id_hvs + (int64_t)pk.x * W + w);
          load_words<VEC>(lv, level_hvs + (int64_t)pk.y * W + w);
#pragma unroll
          for (int v = 0; v < VEC; ++v) x[k][v] = id[v] ^ lv[v];
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) x[k][v] = 0u;
        }
      }
      cnt.add8(x);
    };

    // head/tail are the same in every lane: they only move by ballot counts.
    int head = 0, tail = 0;
    for (int base = 0; base < P; base += 32) {
      const int p = base + lane;
      const bool valid = p < P && mask[row0 + p] != 0;
      const unsigned ballot = __ballot_sync(~0u, valid);
      __syncwarp();                      // earlier groups have read the ring
      if (valid)
        ring[(tail + __popc(ballot & lanes_below)) % RING] =
            make_int2(bins[row0 + p], levels[row0 + p]);
      __syncwarp();
      tail += __popc(ballot);
      for (; tail - head >= GROUP; head += GROUP) add_group(head, GROUP);
    }
    if (tail > head) add_group(head, tail - head);

    if (active) {
      const uint32_t h = static_cast<uint32_t>(tail) >> 1;   // tail == n
      const uint32_t even = (tail & 1) ? 0u : ~0u;
      uint32_t tie[VEC];
      load_words<VEC>(tie, tiebreak + w);
      uint32_t* o = out + b * W + w;
      if constexpr (VEC == 4) {
        *reinterpret_cast<uint4*>(o) =
            make_uint4(cnt.majority(0, h, tie[0], even), cnt.majority(1, h, tie[1], even),
                       cnt.majority(2, h, tie[2], even), cnt.majority(3, h, tie[3], even));
      } else {
        o[0] = cnt.majority(0, h, tie[0], even);
      }
    }
  }
}

template <int VEC, int NU>
cudaError_t launch(const void* bins, const void* levels, const void* mask,
                   const void* id_hvs, const void* level_hvs, const void* tiebreak,
                   void* out, int B, int P, int W, cudaStream_t st) {
  const int64_t chunks = ((int64_t)W + 32 * VEC - 1) / (32 * VEC);
  const dim3 grid((B + WARPS - 1) / WARPS, static_cast<unsigned>(chunks < 65535 ? chunks : 65535));
  hdencode_kernel<VEC, NU><<<grid, WARPS * 32, 0, st>>>(
      static_cast<const int32_t*>(bins), static_cast<const int32_t*>(levels),
      static_cast<const uint8_t*>(mask), static_cast<const uint32_t*>(id_hvs),
      static_cast<const uint32_t*>(level_hvs), static_cast<const uint32_t*>(tiebreak),
      static_cast<uint32_t*>(out), B, P, W);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_planes(int nu, const void* bins, const void* levels,
                            const void* mask, const void* id_hvs,
                            const void* level_hvs, const void* tiebreak, void* out,
                            int B, int P, int W, cudaStream_t st) {
#define REPRO_HDENCODE_NU(N) \
  case N:                    \
    return launch<VEC, N>(bins, levels, mask, id_hvs, level_hvs, tiebreak, out, B, P, W, st)
  switch (nu) {
    REPRO_HDENCODE_NU(0);
    REPRO_HDENCODE_NU(1);
    REPRO_HDENCODE_NU(2);
    REPRO_HDENCODE_NU(3);
    REPRO_HDENCODE_NU(4);
    REPRO_HDENCODE_NU(5);
    REPRO_HDENCODE_NU(6);
    REPRO_HDENCODE_NU(7);
    REPRO_HDENCODE_NU(8);
    default:
      return launch<VEC, NU_GENERAL>(bins, levels, mask, id_hvs, level_hvs, tiebreak,
                                     out, B, P, W, st);
  }
#undef REPRO_HDENCODE_NU
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// bins/levels (B, P) int32, mask (B, P) uint8 {0,1}, id_hvs (F, W),
// level_hvs (L, W), tiebreak (W,), out (B, W) — all packed words as 32-bit
// patterns. Launches on `stream`; returns cudaGetLastError().
extern "C" int hdencode_launch(const void* bins, const void* levels,
                               const void* mask, const void* id_hvs,
                               const void* level_hvs, const void* tiebreak,
                               void* out, int B, int P, int W, void* stream) {
  if (B < 1 || P < 0 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  int nu = 0;                            // bit_length(P >> 3)
  while ((P >> 3) >> nu) ++nu;
  const bool vec4 = W % 4 == 0 && aligned16(id_hvs) && aligned16(level_hvs) &&
                    aligned16(tiebreak) && aligned16(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      vec4 ? dispatch_planes<4>(nu, bins, levels, mask, id_hvs, level_hvs, tiebreak,
                                out, B, P, W, st)
           : dispatch_planes<1>(nu, bins, levels, mask, id_hvs, level_hvs, tiebreak,
                                out, B, P, W, st);
  return static_cast<int>(e);
}
