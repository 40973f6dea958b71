// All-pairs Hamming tile on the int8 tensor cores for Hopper (sm_90a):
// q (Q, W) x r (R, W) packed uint32 words -> out (Q, R) int32,
// out[i][j] = popcount(q[i] ^ r[j]) over dim = 32 * W bits.
//
// Replaces the Pallas TPU kernel repro/kernels/hamming_mxu/hamming_mxu.py
// (hamming_mxu_kernel, launched by hamming_matrix_mxu_pallas): backend
// kernel_mxu, and the prefix scan, seed pass and survivor rescore of the
// dimension cascade for kernel_mxu and fused_mxu.
//
// What bounds it on this card: bytes. At the main-path tile (16 queries x
// 143,360 rows x 128 words) the reference rows (73.4 MB) and the output
// tile (9.2 MB) take ~25 us at 3.35 TB/s, at the cascade's row bucket
// (4,194,304 rows) ~0.72 ms. One m16n8k32 MMA per row word and query tile
// needs ~0.43 ms there at the 0.59 per clock per SM that mma.sync issues,
// so the MMAs, the integer work that turns packed row words into int8
// operands and the loads all have to overlap, and the operands must stay
// cheap: two nibble expansions per MMA (~10 integer instructions) would
// alone take as long as the bytes, while one AND per B register keeps
// mma.sync within 5% of its rate on raw words (scripts/bmma_probe.py).
//
// Design (see pm1_mma.cuh for the weighted bit map): ham(q, r) = |q| +
// sum_k (1 - 2 q_k) r_k, with the row bits entering as 0 / 2^p bytes, one
// AND per B register, and the queries as +-a_p bytes, expanded once per
// CTA into A fragments in shared memory (16 B per lane and word: 64 KB for
// a 128-word chunk; wider rows are taken in 128-word chunks, each chunk's
// dot added to the stored tile, |q| added by the last). The grid has one
// CTA of 8 warps per SM; each warp takes one contiguous run of n8 tiles
// (8 rows), an even share of all of them, in groups of NT = 4 tiles (the
// last one partial: its dead tiles load nothing and are not stored), so
// each A register quad read from shared memory feeds NT MMAs. Lane 4g + t
// loads words 16s + 4t .. 16s + 4t + 3 of row g of each tile with one
// 16-byte load per step s (four bounds-checked word loads when W % 4 != 0
// or a row slice is not 16-byte aligned; the 16-byte loads ask L2 for the
// 256-byte block around them). The loads come in batches of 4 steps (64
// words) of all NT tiles, 8 KB a warp; each batch is issued before the
// previous one's MMAs, across groups, and the first before the A
// fragments are built, so the row loop has no barrier and a batch is in
// flight while the warp multiplies. Words past W read as zero on both sides
// and add nothing; rows and queries past the end are not stored. The C
// fragment holds two adjacent columns of one query row per register pair,
// written as one 8-byte store (two 4-byte stores when R is odd).
#include <cstdint>
#include <cuda_runtime.h>

#include "pm1_mma.cuh"

namespace {

constexpr int QT = 16;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NT = 4;                       // n8 tiles per group: 32 rows
constexpr int BATCH_STEPS = 4;              // steps per load batch: 64 words
constexpr int KW = 128;                     // words of A fragments per chunk
constexpr int CHUNK_STEPS = KW / PM1_STEP_WORDS;
constexpr int STEP_REGS = PM1_STEP_MMAS * 32;   // uint4 A quads per step
static_assert(THREADS / 16 == QT, "query staging: 16 threads per query row");

struct Chunk {
  const uint32_t* r;
  int32_t* out;
  int R, W, w0, nw, steps, q0, nq, g, t, qn_a, qn_b;
  bool first, last;   // the first chunk stores its dot, later ones add;
                      // the last adds |q|
};

// Stage words [w0, w0 + 16 * steps) of the CTA's queries (zero past `end`
// and past nq rows) in s_q, (QT, 16 * steps) words, then expand them into
// A fragments: s_a[(s * 16 + m) * 32 + lane] is the lane's register quad
// for MMA m of step s.
__device__ __forceinline__ void stage_weighted_a(uint4* s_a, uint32_t* s_q, const uint32_t* q,
                                                 int nq, int W, int w0, int end, int steps) {
  const int nwp = steps * PM1_STEP_WORDS;
  {
    const int row = threadIdx.x >> 4;        // THREADS / 16 == QT
    for (int u = threadIdx.x & 15; u < nwp / 4; u += 16) {
      const uint4 v = row < nq ? pm1_load4<1>(q + (size_t)row * W + w0, 4 * u, end - w0)
                               : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(s_q + row * nwp + 4 * u) = v;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < steps * STEP_REGS; i += THREADS) {
    const int lane = i & 31;
    const int m = (i >> 5) & (PM1_STEP_MMAS - 1);
    const int s = i / STEP_REGS;
    const int g = lane >> 2;
    const int p = pm1_bit_pos(m);
    const uint32_t* qa = s_q + g * nwp + s * PM1_STEP_WORDS + 4 * (lane & 3) +
                         2 * pm1_word_pair(m);
    const uint32_t* qb = qa + 8 * nwp;
    s_a[i] = make_uint4(pm1_weighted(qa[0], p), pm1_weighted(qb[0], p),
                        pm1_weighted(qa[1], p), pm1_weighted(qb[1], p));
  }
}

// Steps [step0, step0 + BATCH_STEPS) of tiles [tile0, tile0 + NT): the
// lane's 4 words of row g of each tile per step, zero for rows past R and
// tiles past the warp's run.
template <int VEC>
__device__ __forceinline__ void load_batch(uint4 (&rv)[BATCH_STEPS][NT], const Chunk& c,
                                           int tile0, int tile_hi, int step0) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int row = (tile0 + nt) * 8 + c.g;
    const bool live = tile0 + nt < tile_hi && row < c.R;
    const uint32_t* rr = c.r + (size_t)(live ? row : 0) * c.W + c.w0;
#pragma unroll
    for (int s = 0; s < BATCH_STEPS; ++s)
      rv[s][nt] = live ? pm1_load4<VEC>(rr, (step0 + s) * PM1_STEP_WORDS + 4 * c.t, c.nw)
                       : make_uint4(0u, 0u, 0u, 0u);
  }
}

// The tile's columns 2t, 2t + 1 of query rows g and g + 8 for tiles
// [tile0, min(tile0 + NT, tile_hi)).
__device__ __forceinline__ void store_group(const Chunk& c, const int32_t (&lo)[NT][4],
                                            const int32_t (&hi)[NT][4], int tile0,
                                            int tile_hi) {
  const bool pairs = (c.R & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = (tile0 + nt) * 8 + 2 * c.t;
    if (tile0 + nt >= tile_hi || col >= c.R) continue;
    int2 ha = make_int2((lo[nt][0] >> 3) + (hi[nt][0] >> 7), (lo[nt][1] >> 3) + (hi[nt][1] >> 7));
    int2 hb = make_int2((lo[nt][2] >> 3) + (hi[nt][2] >> 7), (lo[nt][3] >> 3) + (hi[nt][3] >> 7));
    int32_t* oa = c.out + (size_t)(c.q0 + c.g) * c.R + col;
    int32_t* ob = c.out + (size_t)(c.q0 + c.g + 8) * c.R + col;
    const bool two = col + 1 < c.R;
    if (c.last) {
      ha.x += c.qn_a;
      ha.y += c.qn_a;
      hb.x += c.qn_b;
      hb.y += c.qn_b;
    }
    if (!c.first) {                            // a later chunk: add to the tile
      if (c.g < c.nq) {
        ha.x += oa[0];
        if (two) ha.y += oa[1];
      }
      if (c.g + 8 < c.nq) {
        hb.x += ob[0];
        if (two) hb.y += ob[1];
      }
    }
    if (pairs) {                              // col even, R even: 8-byte aligned
      if (c.g < c.nq) *reinterpret_cast<int2*>(oa) = ha;
      if (c.g + 8 < c.nq) *reinterpret_cast<int2*>(ob) = hb;
    } else {
      if (c.g < c.nq) {
        oa[0] = ha.x;
        if (two) oa[1] = ha.y;
      }
      if (c.g + 8 < c.nq) {
        ob[0] = hb.x;
        if (two) ob[1] = hb.y;
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS, 1)   // ~230 registers: one CTA per SM
hamming_mxu_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
                   int32_t* __restrict__ out, int Q, int R, int W) {
  // A fragments of one chunk, then its raw query words.
  extern __shared__ uint4 s_a[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Chunk c;
  c.r = r;
  c.out = out;
  c.R = R;
  c.W = W;
  c.q0 = blockIdx.y * QT;
  c.nq = min(QT, Q - c.q0);
  c.g = lane >> 2;
  c.t = lane & 3;
  c.qn_a = c.qn_b = 0;
  const uint32_t* qt = q + (size_t)c.q0 * W;

  // This warp's run of n8 tiles, in groups of NT (the last one partial).
  const long long n_tiles = (R + 7) / 8;
  const long long n_warps = (long long)gridDim.x * WARPS;
  const long long gw = (long long)blockIdx.x * WARPS + warp;
  const int tile_lo = static_cast<int>(n_tiles * gw / n_warps);
  const int tile_hi = static_cast<int>(n_tiles * (gw + 1) / n_warps);
  const int n_groups = (tile_hi - tile_lo + NT - 1) / NT;
  const uint4* s_a_lane = s_a + lane;

  for (c.w0 = 0; c.w0 < W; c.w0 += KW) {
    c.nw = min(KW, W - c.w0);
    c.steps = (c.nw + PM1_STEP_WORDS - 1) / PM1_STEP_WORDS;
    c.first = c.w0 == 0;
    c.last = c.w0 + KW >= W;
    uint32_t* s_q = reinterpret_cast<uint32_t*>(s_a + c.steps * STEP_REGS);
    // (group, batch) pairs in order, each batch's loads issued before the
    // previous batch's MMAs; the first batch goes out before the A
    // fragments are built.
    const int nb = (c.steps + BATCH_STEPS - 1) / BATCH_STEPS;
    uint4 nxt[BATCH_STEPS][NT];
    if (n_groups > 0) load_batch<VEC>(nxt, c, tile_lo, tile_hi, 0);
    if (!c.first) __syncthreads();           // the previous chunk is consumed
    stage_weighted_a(s_a, s_q, qt, c.nq, W, c.w0, c.w0 + c.nw, c.steps);
    // |q| of rows g and g + 8 over the chunk: lane t sums words t, t + 4,
    // ..., then the quad.
    const int nwp = c.steps * PM1_STEP_WORDS;
    int qa = 0, qb = 0;
    for (int w = c.t; w < nwp; w += 4) {
      qa += __popc(s_q[c.g * nwp + w]);
      qb += __popc(s_q[(c.g + 8) * nwp + w]);
    }
    qa += __shfl_xor_sync(~0u, qa, 1);
    qa += __shfl_xor_sync(~0u, qa, 2);
    qb += __shfl_xor_sync(~0u, qb, 1);
    qb += __shfl_xor_sync(~0u, qb, 2);
    c.qn_a += qa;
    c.qn_b += qb;
    __syncthreads();

    int32_t lo[NT][4], hi[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) lo[nt][e] = hi[nt][e] = 0;
    for (int grp = 0, b = 0; grp < n_groups;) {
      uint4 cur[BATCH_STEPS][NT];
#pragma unroll
      for (int s = 0; s < BATCH_STEPS; ++s)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) cur[s][nt] = nxt[s][nt];
      const int tile0 = tile_lo + grp * NT;
      const bool end = b + 1 == nb;
      if (!end) load_batch<VEC>(nxt, c, tile0, tile_hi, (b + 1) * BATCH_STEPS);
      else if (grp + 1 < n_groups) load_batch<VEC>(nxt, c, tile0 + NT, tile_hi, 0);
#pragma unroll
      for (int s = 0; s < BATCH_STEPS; ++s) {
        const int step = b * BATCH_STEPS + s;
        if (step >= c.steps) break;          // the same for the whole warp
        mma_weighted_step<NT>(lo, hi, s_a_lane + step * STEP_REGS, cur[s]);
      }
      if (end) {
        store_group(c, lo, hi, tile0, tile_hi);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) lo[nt][e] = hi[nt][e] = 0;
        ++grp;
        b = 0;
      } else {
        ++b;
      }
    }
  }
}

template <int VEC>
cudaError_t launch(const void* q, const void* r, void* out, int Q, int R, int W,
                   int ctas_per_sm, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(hamming_mxu_kernel<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  // CTAs: enough to fill every SM at the kernel's occupancy (or at
  // ctas_per_sm CTAs an SM when that is > 0), shared among the query tiles,
  // never more than there are n8 tiles for. The CTAs stride over the n8
  // tiles, so the output is the same at every grid.
  int dev = 0, n_sms = 0, per_sm = ctas_per_sm;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && ctas_per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hamming_mxu_kernel<VEC>,
                                                      THREADS, smem);
  if (e != cudaSuccess) return e;
  const int q_tiles = (Q + QT - 1) / QT;
  const long long fill = (long long)n_sms * (per_sm > 0 ? per_sm : 1) / q_tiles;
  const long long need = ((long long)R + 8 * WARPS - 1) / (8 * WARPS);
  const long long x = need < fill ? need : fill;
  const dim3 grid(static_cast<unsigned>(x > 0 ? x : 1), q_tiles);
  hamming_mxu_kernel<VEC><<<grid, THREADS, smem, st>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<int32_t*>(out), Q, R, W);
  return cudaGetLastError();
}

}  // namespace

// q (Q, W), r (R, W) uint32, out (Q, R) int32, all contiguous on the
// device; dim must be 32 * W; ctas_per_sm 0 fills the SMs at the kernel's
// occupancy. Launches on `stream`; returns cudaGetLastError().
extern "C" int hamming_mxu_launch(const void* q, const void* r, void* out, int Q,
                                  int R, int W, int dim, int ctas_per_sm,
                                  void* stream) {
  if (Q < 1 || R < 1 || W < 1 || dim != 32 * W || ctas_per_sm < 0 ||
      (Q + QT - 1) / QT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int steps = W < KW ? (W + PM1_STEP_WORDS - 1) / PM1_STEP_WORDS : CHUNK_STEPS;
  const size_t smem = (sizeof(uint4) * STEP_REGS + sizeof(uint32_t) * QT * PM1_STEP_WORDS) *
                      steps;
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  return static_cast<int>(vec4 ? launch<4>(q, r, out, Q, R, W, ctas_per_sm, smem, st)
                               : launch<1>(q, r, out, Q, R, W, ctas_per_sm, smem, st));
}
