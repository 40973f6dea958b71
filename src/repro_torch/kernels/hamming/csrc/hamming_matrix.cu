// All-pairs Hamming tile for Hopper (sm_90a): q (Q, W) x r (R, W) packed
// uint32 words -> out (Q, R) int32, out[i][j] = popcount(q[i] ^ r[j]).
//
// Replaces the Pallas TPU kernel repro/kernels/hamming/hamming.py
// (hamming_matrix_kernel, launched by hamming_matrix_pallas): backend
// kernel_vpu, and the prefix scan and survivor rescore of the dimension
// cascade for every matrix backend of that kind.
//
// What bounds it on this card: bytes. At the main-path tile (16 queries x
// 143,360 rows x 128 words) the reference rows (73.4 MB) and the output
// tile (9.2 MB) take ~25 us at 3.35 TB/s. The popc route alone (one XOR +
// popc per pair-word, 16 popc per clock per SM) needs ~70 us, so the pairs
// go to the tensor cores: the binary MMA
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc takes 8 packed
// words per operand row and issues at 0.589 per clock per SM, the rate of
// the int8 m16n8k32 MMA (scripts/bmma_probe.py on an NVIDIA H100 80GB
// HBM3, 700.00 W). Its .xor.popc form, which would give the Hamming count
// directly, compiles without a warning but issues at 0.094 per clock per
// SM there, so the kernel takes the AND form and the identity
//   ham(q, r) = |q| + |r| - 2 * popc(q & r).
//
// Design: a CTA stages its QT = 16 queries (zero-padded to a multiple of 16
// words) in shared memory, each warp sums |q| from there, then walks
// n8 tiles of 8 reference rows, grid-stride. Lane 4g + t loads words
// 16s + 4t .. 16s + 4t + 3 of row g with one 16-byte load per step s (four
// word loads, each bounds-checked, when W % 4 != 0 or a row slice is not
// 16-byte aligned), eight steps (128 words) at a time, all in flight
// before the first MMA. Each step is two MMAs: words 16s + 4t + {0, 1}
// feed the first (A: a0/a1 = rows g/g+8, a2/a3 the next word; B: b0, b1)
// and words + {2, 3} the second, so A and B share one bit-to-k map and the
// sum over k is popc(q & r). The same loaded words give |r|: one popc per
// lane and word, 1/16 of the popc route, summed over the quad and moved
// to the C fragment's columns by shuffles. Words past W read as zero on
// both sides, which changes neither popc(q & r) nor |q|, |r|; rows and
// queries past the end are not stored. The C fragment holds two adjacent
// columns of one query row per register pair, written as one 8-byte store
// (two 4-byte stores when R is odd): each warp store covers whole 32-byte
// sectors of 16 query rows.
#include <cstdint>
#include <cuda_runtime.h>

#include "bmma.cuh"

namespace {

constexpr int QT = 16;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BATCH_STEPS = 8;              // steps loaded together: 128 words

template <int VEC>
__global__ void __launch_bounds__(THREADS)
hamming_matrix_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ r,
                      int32_t* __restrict__ out, int Q, int R, int W) {
  // (QT, Wp) queries, 16-byte chunk u of row g stored at u ^ swz when g is
  // odd, so the two rows a quarter-warp reads fall in different banks.
  extern __shared__ __align__(16) uint32_t s_q[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int Wp = (W + STEP_WORDS - 1) / STEP_WORDS * STEP_WORDS;
  const int swz = (Wp & 16) ? 0 : 4;
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, Q - q0);

  // Stage the queries: thread tid takes row tid / 16 and every 16th chunk
  // of four words from tid % 16.
  {
    const int row = tid >> 4;
    const uint32_t* qr = q + (size_t)(q0 + row) * W;
    for (int u = tid & 15; u < Wp / 4; u += 16) {
      const uint4 v = row < nq ? load4<1>(qr, 4 * u, W) : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(s_q + row * Wp + 4 * ((row & 1) ? (u ^ swz) : u)) = v;
    }
  }
  __syncthreads();

  const uint4* qa = reinterpret_cast<const uint4*>(s_q + g * Wp);
  const uint4* qb = reinterpret_cast<const uint4*>(s_q + (g + 8) * Wp);
  const int qsw = (g & 1) ? swz : 0;        // rows g and g + 8 share parity
  // |q| of rows g and g + 8: lane t sums chunks t, t + 4, ..., then the quad.
  int qn_a = 0, qn_b = 0;
  for (int u = t; u < Wp / 4; u += 4) {
    const uint4 a = qa[u ^ qsw];
    const uint4 b = qb[u ^ qsw];
    qn_a += __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
    qn_b += __popc(b.x) + __popc(b.y) + __popc(b.z) + __popc(b.w);
  }
  qn_a += __shfl_xor_sync(~0u, qn_a, 1);
  qn_a += __shfl_xor_sync(~0u, qn_a, 2);
  qn_b += __shfl_xor_sync(~0u, qn_b, 1);
  qn_b += __shfl_xor_sync(~0u, qn_b, 2);
  const int n_tiles = (R + 7) / 8;
  const bool pairs = (R & 1) == 0;

  for (int tile = blockIdx.x * WARPS + warp; tile < n_tiles;
       tile += gridDim.x * WARPS) {
    const int row = tile * 8 + g;
    const uint32_t* rr = r + (size_t)min(row, R - 1) * W;
    const bool live = row < R;
    int32_t c[4] = {0, 0, 0, 0};
    int rn = 0;
    for (int w0 = 0; w0 < W; w0 += BATCH_STEPS * STEP_WORDS) {
      uint4 rv[BATCH_STEPS];
#pragma unroll
      for (int s = 0; s < BATCH_STEPS; ++s) {
        const int w = w0 + s * STEP_WORDS + 4 * t;
        rv[s] = live ? load4<VEC>(rr, w, W) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int s = 0; s < BATCH_STEPS; ++s) {
        const int step_w = w0 + s * STEP_WORDS;
        if (step_w >= W) break;              // the same for the whole warp
        const int u = (step_w >> 2) + t;
        const uint4 a = qa[u ^ qsw];
        const uint4 b = qb[u ^ qsw];
        mma_and_popc(c, a.x, b.x, a.y, b.y, rv[s].x, rv[s].y);
        mma_and_popc(c, a.z, b.z, a.w, b.w, rv[s].z, rv[s].w);
        rn += __popc(rv[s].x) + __popc(rv[s].y) + __popc(rv[s].z) + __popc(rv[s].w);
      }
    }
    // |r| of row g over the quad, then of the C columns 2t and 2t + 1
    // (rows held by groups 2t and 2t + 1, i.e. lanes 8t and 8t + 4).
    rn += __shfl_xor_sync(~0u, rn, 1);
    rn += __shfl_xor_sync(~0u, rn, 2);
    const int rn0 = __shfl_sync(~0u, rn, 8 * t);
    const int rn1 = __shfl_sync(~0u, rn, 8 * t + 4);
    const int col = tile * 8 + 2 * t;
    if (col >= R) continue;
    const int2 ha = make_int2(qn_a + rn0 - 2 * c[0], qn_a + rn1 - 2 * c[1]);
    const int2 hb = make_int2(qn_b + rn0 - 2 * c[2], qn_b + rn1 - 2 * c[3]);
    int32_t* oa = out + (size_t)(q0 + g) * R + col;
    int32_t* ob = out + (size_t)(q0 + g + 8) * R + col;
    if (pairs) {                              // col even, R even: 8-byte aligned
      if (g < nq) *reinterpret_cast<int2*>(oa) = ha;
      if (g + 8 < nq) *reinterpret_cast<int2*>(ob) = hb;
    } else {
      const bool two = col + 1 < R;
      if (g < nq) {
        oa[0] = ha.x;
        if (two) oa[1] = ha.y;
      }
      if (g + 8 < nq) {
        ob[0] = hb.x;
        if (two) ob[1] = hb.y;
      }
    }
  }
}

template <int VEC>
cudaError_t launch(const void* q, const void* r, void* out, int Q, int R, int W,
                   int ctas_per_sm, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(hamming_matrix_kernel<VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  // CTAs: enough to fill every SM at the kernel's occupancy (or at
  // ctas_per_sm CTAs an SM when that is > 0), never more than there are n8
  // tiles for. The CTAs stride over the n8 tiles, so the output is the
  // same at every grid.
  int dev = 0, n_sms = 0, per_sm = ctas_per_sm;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && ctas_per_sm == 0)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hamming_matrix_kernel<VEC>, THREADS, smem);
  if (e != cudaSuccess) return e;
  const long long fill = (long long)n_sms * (per_sm > 0 ? per_sm : 1);
  const long long need = ((long long)R + 8 * WARPS - 1) / (8 * WARPS);
  const dim3 grid(static_cast<unsigned>(need < fill ? need : fill), (Q + QT - 1) / QT);
  hamming_matrix_kernel<VEC><<<grid, THREADS, smem, st>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(r),
      static_cast<int32_t*>(out), Q, R, W);
  return cudaGetLastError();
}

}  // namespace

// q (Q, W), r (R, W) uint32, out (Q, R) int32, all contiguous on the
// device; ctas_per_sm 0 fills the SMs at the kernel's occupancy. Launches
// on `stream`; returns cudaGetLastError().
extern "C" int hamming_matrix_launch(const void* q, const void* r, void* out,
                                     int Q, int R, int W, int ctas_per_sm,
                                     void* stream) {
  if (Q < 1 || R < 1 || W < 1 || ctas_per_sm < 0 || (Q + QT - 1) / QT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t wp = ((size_t)W + STEP_WORDS - 1) / STEP_WORDS * STEP_WORDS;
  const size_t smem = sizeof(uint32_t) * QT * wp;
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0;
  return static_cast<int>(vec4 ? launch<4>(q, r, out, Q, R, W, ctas_per_sm, smem, st)
                               : launch<1>(q, r, out, Q, R, W, ctas_per_sm, smem, st));
}
