// The grouped fused dual-window search shared by fused_search.cu (binary
// AND-popc tensor cores) and fused_search_mxu.cu (+-1 int8 tensor cores).
// A `Route` supplies the Hamming tile's MMA loop and its sim; everything
// else is here: the groups, the splits, the query staging, the epilogue on
// the C fragments and the winner lists.
//
// Launch contract (both launchers): every 16-query tile t scans rows
// [tile_start[t], tile_start[t] + rk) ∩ [0, n_rows); per (query, window)
// the k best rows by (sim desc, row asc); padded queries carry a charge
// no row has, padded rows pmz >= pad_pmz.
//
// Design:
//  * Query-block groups. A CTA serves a group of G consecutive tiles (G =
//    GROUP, or 1 where G tiles' queries do not fit in shared memory) and
//    walks the union of their row ranges, [min start, max start + rk),
//    clipped to n_rows. Neighbouring query blocks start on the same or
//    nearby rows (start rows are sorted block keys), so each row is loaded
//    once for G * 16 queries instead of 16. The epilogue masks each tile to
//    its own range, so a row outside it is never offered to that tile and
//    the result equals the per-tile scan by construction. Groups are
//    consecutive runs of G tiles and the union is computed in the kernel,
//    so the host never reads the start rows.
//  * Splits. The union of a group is cut into gridDim.x contiguous chunks,
//    one CTA each (blockIdx.y is the group), so that every SM has work.
//  * Register tiles. Each warp takes 32 rows (NT = 4 n8 tiles) per pass and
//    keeps the accumulators of all G tiles x NT n8 tiles in registers
//    across the word loop: one A fragment (queries, from shared memory)
//    serves NT MMAs and one B fragment (rows) serves G. A route supplies
//    the MMAs of one 16-word stage (Route::step); it gets
//    Route::scratch_bytes(G) of shared memory of its own and may
//    synchronise the CTA in its step (passes and steps are uniform).
//  * Row streaming. With one CTA of 8 warps per SM (the accumulators take
//    most registers), few loads are in flight per SM. Each warp streams its
//    rows through a private ring of NSTAGE 2 KB stages in shared memory
//    with cp.async, NSTAGE - 1 stages ahead of its MMAs, across passes.
//  * Epilogue on the C fragments. Lane 4g + t holds queries g and g + 8 of
//    every tile against rows 2t and 2t + 1 of every n8 tile. Charge, PAD,
//    the tile's row range and both windows are applied per pair with the
//    reference's rounding (std window d <= __fmul_rn(q_pmz, std_scale),
//    std_scale rounded once on the host; d = |__fsub_rn(q_pmz, r_pmz)|).
//    A pair reaches its list only when its sim reaches the list's k-th
//    sim (list_threshold, read once per pass): a branch-free filter over
//    all of a pass's pairs on the open list's k-th sim and the std window
//    flags (tile, query half) groups, one warp-wide OR gathers the flags,
//    and only flagged groups run the exact test (out of line, offer_pairs),
//    which is rare once the lists fill. The quads of a warp offer their
//    flagged pairs best first, so a list takes at most k insertions per
//    quad and pass.
//  * Winners. One list of k composite keys per (query, window) per CTA in
//    shared memory, filled by all warps with insert_atomic (winners.cuh);
//    at the end each list is the CTA's partial for its split, and
//    fused_search_merge merges the splits.
//  * Any k and W (GLOBAL_LISTS). Where k > KSHARED or one tile's queries and
//    lists do not fit in shared memory, the lists live in device memory, one
//    per (tile, list) shared by every split of the group, and all CTAs
//    insert with insert_atomic_from (the chains merge the splits;
//    fused_search_decode decodes). Shared memory then holds G = GROUP
//    tiles' queries, in word chunks of `qw` (a multiple of 32 words) where
//    all Wp words do not fit: each pass stages a chunk before its steps,
//    between two CTA barriers, and the route reads it through a pointer
//    shifted back by the chunk's first word (32-word chunks keep the
//    swizzle's XOR inside the chunk). |q| then comes from device memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "winners.cuh"

namespace {

constexpr int GROUP = 8;                      // query tiles per CTA
constexpr int NT = 4;                         // n8 row tiles per warp pass
constexpr int WARP_ROWS = NT * 8;             // rows per warp pass: 32
constexpr int PASS_ROWS = NWARPS * WARP_ROWS; // rows per CTA pass: 256
constexpr int STAGE_WORDS = 16;               // words of a row per ring stage
constexpr int NSTAGE = 4;                     // ring stages per warp
constexpr int STAGE_U32 = WARP_ROWS * STAGE_WORDS;         // 2 KB a stage
constexpr size_t RING_BYTES = sizeof(uint32_t) * NWARPS * NSTAGE * STAGE_U32;
constexpr size_t SMEM_BUDGET = 220 * 1024;    // dynamic shared memory cap
constexpr int MAX_GRID_Y = 65535;             // groups per launch (gridDim.y)

// Words per staged query row: W rounded up to a 16-word MMA step.
__host__ __device__ __forceinline__ int padded_words(int W) { return (W + 15) / 16 * 16; }

// Staged query rows: 16-byte chunk u of an odd row is stored at u ^ swz, so
// the rows g and g + 1 that a quarter-warp reads fall in different banks.
__device__ __forceinline__ int chunk_swizzle(int Wp) { return (Wp & 16) ? 0 : 4; }

// cp.async of 16 (or 4) bytes into shared memory; `valid` false writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One ring stage: words [w0, w0 + 16) of the warp's rows [base, base + 32)
// into slot (row-major, 16 words a row), zeros past `end` and past W.
// VEC == 4: 16-byte copies (W % 4 == 0, 16-byte aligned rows).
template <int VEC>
__device__ __forceinline__ void issue_stage(uint32_t* slot, const uint32_t* r, int base,
                                            int end, int w0, int W, int lane) {
  if constexpr (VEC == 4) {
#pragma unroll
    for (int c = lane; c < WARP_ROWS * STAGE_WORDS / 4; c += 32) {
      const int row = base + (c >> 2);
      const int w = w0 + 4 * (c & 3);
      const bool ok = row < end && w < W;
      cp_async16(slot + 4 * c, ok ? r + (size_t)row * W + w : r, ok);
    }
  } else {
    for (int c = lane; c < WARP_ROWS * STAGE_WORDS; c += 32) {
      const int row = base + c / STAGE_WORDS;
      const int w = w0 + c % STAGE_WORDS;
      const bool ok = row < end && w < W;
      cp_async4(slot + c, ok ? r + (size_t)row * W + w : r, ok);
    }
  }
}

struct __align__(16) QueryInfo {
  float pmz;
  float std_tol;     // __fmul_rn(pmz, std_scale)
  int32_t charge;
  int32_t dq;        // dim - |q| (routes that need it)
};

// A pass's values of one (tile, query) for the pairs of one lane: sim and
// row pmz per bit 2 nt + e (row row0 + 8 nt + e).
struct LanePairs {
  int sim[NT * 2];
  float rp[NT * 2];
};

// Offer the pairs flagged in m to one list that the lane's quad shares (its
// four lanes hold the same query). Round by round each lane puts up its
// best flagged key, the quad's best is inserted, and every lane drops the
// pairs that fall below the list's k-th sim; so a quad makes at most k
// insertions per call and one per list once the list is full. All 32
// lanes must call it. GLOBAL_LISTS: the list is in device memory.
template <bool GLOBAL_LISTS>
__device__ __forceinline__ void offer_quad(winner_t* list, int k, unsigned m,
                                           const LanePairs& p, int row0) {
  while (__any_sync(FULL, m)) {
    winner_t best = 0ull;
    int bit = 0;
#pragma unroll
    for (int b = 0; b < NT * 2; ++b) {
      const winner_t key = ((winner_t)(uint32_t)p.sim[b] << 32) |
                           (0xFFFFFFFFull - (uint32_t)(row0 + 8 * (b >> 1) + (b & 1)));
      if (((m >> b) & 1u) && key > best) {
        best = key;
        bit = b;
      }
    }
    winner_t top = best;
    top = max(top, __shfl_xor_sync(FULL, top, 1));
    top = max(top, __shfl_xor_sync(FULL, top, 2));
    if (best && best == top) {
      if constexpr (GLOBAL_LISTS)
        insert_atomic_from(list, k, best);
      else
        insert_atomic(list, k, best);
      m &= ~(1u << bit);
    }
    __syncwarp();
    const int thr = list_threshold(list, k);
#pragma unroll
    for (int b = 0; b < NT * 2; ++b)
      if (p.sim[b] < thr) m &= ~(1u << b);
  }
}

// The exact test of the pairs the quick filter flagged (cand: the tile's
// range, the query's charge, and sim >= the open list's k-th sim or inside
// the std window), then the offers to the std and open lists. Kept out of
// line: it runs rarely, and one copy of it keeps the epilogue's code small.
// All 32 lanes must call it.
template <bool GLOBAL_LISTS>
__device__ __noinline__ void offer_pairs(LanePairs p, unsigned cand, float qp, float qstd,
                                         float open_tol, float pad_pmz, winner_t* l_std,
                                         int k, int row0) {
  winner_t* l_open = l_std + k;
  const int thr_s = list_threshold(l_std, k);
  const int thr_o = list_threshold(l_open, k);
  unsigned m_std = 0, m_open = 0;
#pragma unroll
  for (int b = 0; b < NT * 2; ++b) {
    const bool ok = ((cand >> b) & 1u) && p.rp[b] < pad_pmz;
    const float d = fabsf(__fsub_rn(qp, p.rp[b]));
    m_std |= (unsigned)(ok && p.sim[b] >= thr_s && d <= qstd) << b;
    m_open |= (unsigned)(ok && p.sim[b] >= thr_o && d <= open_tol) << b;
  }
  offer_quad<GLOBAL_LISTS>(l_std, k, m_std, p, row0);
  offer_quad<GLOBAL_LISTS>(l_open, k, m_open, p, row0);
}

// GLOBAL_LISTS: the lists are `partial` itself, (tiles, NLISTS, k) zeroed
// by the launcher, and the queries are staged in chunks of qw words (qw =
// Wp: all of them, once); else qw is unused.
template <class Route, int G, int VEC, bool GLOBAL_LISTS>
__global__ void __launch_bounds__(THREADS, 1)
fused_grouped_partial(const uint32_t* __restrict__ q, const float* __restrict__ q_pmz,
                      const int32_t* __restrict__ q_charge,
                      const uint32_t* __restrict__ r, const float* __restrict__ r_pmz,
                      const int32_t* __restrict__ r_charge,
                      const int32_t* __restrict__ tile_start, int n_tiles, int n_rows,
                      int W, int dim, int k, int rk, float std_scale, float open_tol,
                      float pad_pmz, int qw, winner_t* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Wp = padded_words(W);
  const int qs = GLOBAL_LISTS ? qw : Wp;     // words per staged query row
  const int swz = chunk_swizzle(qs);
  uint32_t* s_q = reinterpret_cast<uint32_t*>(smem_raw);               // G*QT x qs
  winner_t* s_list;
  uint32_t* s_ring;
  if constexpr (GLOBAL_LISTS) {
    s_list = partial + (size_t)blockIdx.y * G * NLISTS * k;
    s_ring = s_q + (size_t)G * QT * qs;
  } else {
    s_list = reinterpret_cast<winner_t*>(s_q + (size_t)G * QT * Wp);
    s_ring = reinterpret_cast<uint32_t*>(s_list + (size_t)G * NLISTS * k);
  }
  void* s_scratch = s_ring + NWARPS * NSTAGE * STAGE_U32;               // the route's
  // Per query: pmz, its std window, charge and dim - |q| (Route::kNorms).
  __shared__ QueryInfo s_qi[G * QT];
  __shared__ int32_t s_start[G];
  __shared__ int32_t s_span[2];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int t0 = blockIdx.y * G;
  const int ng = min(G, n_tiles - t0);

  // Stage words [c0, c0 + qs) of the group's queries (tiles past the end
  // as zeros), zero past W.
  auto stage_queries = [&](int c0) {
    const int chunks = qs / 4;
    for (int i = tid; i < G * QT * chunks; i += THREADS) {
      const int qi = i / chunks;
      const int u = i - qi * chunks;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (qi < ng * QT) {
        const int w = c0 + 4 * u;
        const uint32_t* qr = q + (size_t)(t0 * QT + qi) * W + w;
        if (VEC == 4 && w < W) {
          v = __ldg(reinterpret_cast<const uint4*>(qr));
        } else {
          v.x = w < W ? __ldg(qr) : 0u;
          v.y = w + 1 < W ? __ldg(qr + 1) : 0u;
          v.z = w + 2 < W ? __ldg(qr + 2) : 0u;
          v.w = w + 3 < W ? __ldg(qr + 3) : 0u;
        }
      }
      *reinterpret_cast<uint4*>(s_q + (size_t)qi * qs + 4 * ((qi & 1) ? (u ^ swz) : u)) = v;
    }
  };
  // Staged query words per chunk, in 16-word steps; one chunk: staged here.
  const int q_steps = qs / STAGE_WORDS;
  const bool chunked = GLOBAL_LISTS && qs < Wp;
  if (!chunked) stage_queries(0);
  if (tid < G * QT) {
    const bool real = tid < ng * QT;
    const float qp = real ? q_pmz[t0 * QT + tid] : 0.0f;
    s_qi[tid].pmz = qp;
    s_qi[tid].std_tol = __fmul_rn(qp, std_scale);
    s_qi[tid].charge = real ? q_charge[t0 * QT + tid] : -(1 << 30);   // no row's
    s_qi[tid].dq = 0;
  }
  if (tid < G) s_start[tid] = tid < ng ? tile_start[t0 + tid] : 0;
  if constexpr (!GLOBAL_LISTS)
    for (int i = tid; i < G * NLISTS * k; i += THREADS) s_list[i] = 0ull;
  __syncthreads();
  if (tid == 0) {
    long long lo = s_start[0], hi = s_start[0];
    for (int i = 1; i < ng; ++i) {
      lo = min(lo, (long long)s_start[i]);
      hi = max(hi, (long long)s_start[i]);
    }
    s_span[0] = (int)lo;
    s_span[1] = (int)max(lo, min(hi + rk, (long long)n_rows));
  }
  if (Route::kNorms && tid < G * QT) {
    int n = 0;
    if constexpr (GLOBAL_LISTS) {
      if (tid < ng * QT) {
        const uint32_t* row = q + (size_t)(t0 * QT + tid) * W;
        for (int w = 0; w < W; ++w) n += __popc(__ldg(row + w));
      }
    } else {
      const uint32_t* row = s_q + (size_t)tid * Wp;
      for (int w = 0; w < Wp; ++w) n += __popc(row[w]);   // padding words are 0
    }
    s_qi[tid].dq = dim - n;
  }
  __syncthreads();

  // This CTA's chunk of the union, in whole warp passes of 32 rows.
  const int span = s_span[1] - s_span[0];
  const int chunk = ((span + n_splits - 1) / n_splits + 31) / 32 * 32;
  const int begin = s_span[0] + min(span, split * chunk);
  const int end = min(begin + chunk, s_span[1]);

  // Passes and steps are uniform over the CTA (a route may synchronise the
  // CTA in its step); a warp whose rows lie past the end streams zeros and
  // skips the epilogue. Each warp streams its rows through its own ring of
  // NSTAGE stages with cp.async, NSTAGE - 1 stages ahead of its MMAs, across
  // pass boundaries.
  const int n_passes = max(0, end - begin + PASS_ROWS - 1) / PASS_ROWS;
  const int n_steps = (W + STAGE_WORDS - 1) / STAGE_WORDS;
  const int n_stages = n_passes * n_steps;
  uint32_t* ring = s_ring + warp * NSTAGE * STAGE_U32;
  auto issue = [&](int i) {
    if (i < n_stages) {
      const int p = i / n_steps;
      issue_stage<VEC>(ring + (i % NSTAGE) * STAGE_U32, r,
                       begin + p * PASS_ROWS + warp * WARP_ROWS, end,
                       (i - p * n_steps) * STAGE_WORDS, W, lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NSTAGE - 1; ++i) issue(i);

  int stage = 0;
  for (int pass = 0; pass < n_passes; ++pass) {
    const int base = begin + pass * PASS_ROWS + warp * WARP_ROWS;
    // pmz and charge of the warp's rows, one per lane, loaded before the
    // MMAs so that they arrive while these run.
    const int my_row = base + lane;
    const bool my_live = lane < WARP_ROWS && my_row < end;
    const float my_rp = my_live ? __ldg(r_pmz + my_row) : pad_pmz;
    const int32_t my_rc = my_live ? __ldg(r_charge + my_row) : -1;
    int32_t c[G][NT][4];
    int rn[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      rn[nt] = 0;
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int i = 0; i < 4; ++i) c[gi][nt][i] = 0;
    }
    for (int s = 0; s < n_steps; ++s, ++stage) {
      // The chunk that holds this step's words (chunked queries only).
      const int c0 = chunked ? s / q_steps * qs : 0;
      if (chunked && s * STAGE_WORDS == c0) {
        __syncthreads();                        // the previous chunk is read
        stage_queries(c0);
        __syncthreads();
      }
      issue(stage + NSTAGE - 1);
      cp_async_wait<NSTAGE - 1>();
      __syncwarp();
      Route::template step<G>(c, rn, s_q - c0, qs, swz, ring + (stage % NSTAGE) * STAGE_U32,
                              s * STAGE_WORDS, W, tid, s_scratch);
      __syncwarp();
    }
    if (base >= end) continue;

    // Per C column (row 2t + e of n-tile nt): |r| when the route needs it,
    // pmz and charge.
    int rn_col[NT][2];
    float rp[NT][2];
    int32_t rc[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (Route::kNorms) {
        int sum = rn[nt];
        sum += __shfl_xor_sync(FULL, sum, 1);
        sum += __shfl_xor_sync(FULL, sum, 2);
        rn_col[nt][0] = __shfl_sync(FULL, sum, 8 * t);
        rn_col[nt][1] = __shfl_sync(FULL, sum, 8 * t + 4);
      } else {
        rn_col[nt][0] = rn_col[nt][1] = 0;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        rp[nt][e] = __shfl_sync(FULL, my_rp, nt * 8 + 2 * t + e);
        rc[nt][e] = __shfl_sync(FULL, my_rc, nt * 8 + 2 * t + e);
      }
    }

    // Quick filter over all of the pass's pairs, without a branch: a pair
    // of the query's charge can enter the std list only inside the std
    // window and the open list only at its k-th sim or above. Both are rare
    // once the lists fill. Bit 2 gi + h of `groups` flags the (tile,
    // query half) groups with such a pair in some lane; only those run the
    // exact test.
    unsigned cand[G][2];
    unsigned groups = 0;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const QueryInfo qi = s_qi[gi * QT + g + 8 * h];
        // Device lists exist only for the group's real tiles (a padded
        // tile's queries match no row's charge).
        const int thr_o = GLOBAL_LISTS && gi >= ng ? 0 : list_threshold(
            s_list + (size_t)(gi * NLISTS + 2 * (g + 8 * h) + 1) * k, k);
        unsigned m = 0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int sim = Route::sim(c[gi][nt][2 * h + e], qi.dq, rn_col[nt][e], dim);
            const float d = fabsf(__fsub_rn(qi.pmz, rp[nt][e]));
            m |= (unsigned)(rc[nt][e] == qi.charge && (sim >= thr_o || d <= qi.std_tol))
                 << (2 * nt + e);
          }
        cand[gi][h] = m;
        groups |= (unsigned)(m != 0) << (2 * gi + h);
      }
    }
    groups = __reduce_or_sync(FULL, groups);
    if (!groups) continue;

    // The exact test of the flagged groups: the tile's range, then
    // offer_pairs.
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (gi < ng && ((groups >> (2 * gi)) & 3u)) {
        // Bit 2 nt + e: row 2t + e of n-tile nt lies in tile gi's range.
        const int start = s_start[gi];
        unsigned in_tile = 0;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            in_tile |= (unsigned)((unsigned)(base + nt * 8 + 2 * t + e - start) < (unsigned)rk)
                       << (2 * nt + e);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if ((groups >> (2 * gi + h)) & 1u) {
            const QueryInfo qi = s_qi[gi * QT + g + 8 * h];
            LanePairs p;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                p.sim[2 * nt + e] = Route::sim(c[gi][nt][2 * h + e], qi.dq, rn_col[nt][e], dim);
                p.rp[2 * nt + e] = rp[nt][e];
              }
            offer_pairs<GLOBAL_LISTS>(p, cand[gi][h] & in_tile, qi.pmz, qi.std_tol, open_tol, pad_pmz,
                        s_list + (size_t)(gi * NLISTS + 2 * (g + 8 * h)) * k, k,
                        base + 2 * t);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (!GLOBAL_LISTS) {
    __syncthreads();
    for (int i = tid; i < ng * NLISTS * k; i += THREADS) {
      const int gi = i / (NLISTS * k);
      partial[((size_t)(t0 + gi) * n_splits + split) * NLISTS * k + (i - gi * NLISTS * k)] =
          s_list[i];
    }
  }
}

template <class Route, int G, int VEC, bool GLOBAL_LISTS>
int launch_partial(const void* q, const void* q_pmz, const void* q_charge, const void* r,
                   const void* r_pmz, const void* r_charge, const void* tile_start,
                   void* partial, int n_tiles, int n_rows, int W, int dim, int k, int rk,
                   int n_splits, float std_scale, float open_tol, float pad_pmz, int qw,
                   size_t smem, cudaStream_t st) {
  auto kern = fused_grouped_partial<Route, G, VEC, GLOBAL_LISTS>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  // blockIdx.y is the group: batches of more than MAX_GRID_Y groups run as
  // several launches over consecutive tiles (the kernel sees its batch's
  // first tile as tile 0).
  const int n_groups = (n_tiles + G - 1) / G;
  const size_t tile_keys = (size_t)(GLOBAL_LISTS ? 1 : n_splits) * NLISTS * k;
  for (int g0 = 0; g0 < n_groups; g0 += MAX_GRID_Y) {
    const int t0 = g0 * G;
    const int ng = n_groups - g0 < MAX_GRID_Y ? n_groups - g0 : MAX_GRID_Y;
    const dim3 grid(n_splits, ng);
    kern<<<grid, THREADS, smem, st>>>(
        static_cast<const uint32_t*>(q) + (size_t)t0 * QT * W,
        static_cast<const float*>(q_pmz) + (size_t)t0 * QT,
        static_cast<const int32_t*>(q_charge) + (size_t)t0 * QT,
        static_cast<const uint32_t*>(r), static_cast<const float*>(r_pmz),
        static_cast<const int32_t*>(r_charge), static_cast<const int32_t*>(tile_start) + t0,
        n_tiles - t0 < ng * G ? n_tiles - t0 : ng * G, n_rows, W, dim, k, rk, std_scale,
        open_tol, pad_pmz, qw, static_cast<winner_t*>(partial) + (size_t)t0 * tile_keys);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// Words of each query row that the device-list path stages at a time with
// `scratch` bytes of route scratch: all Wp where they fit, else the most
// that fit in multiples of 32 words.
inline int query_chunk_words(int W, size_t scratch) {
  const long long fit =
      ((long long)SMEM_BUDGET - (long long)RING_BYTES - (long long)scratch) /
      ((long long)sizeof(uint32_t) * GROUP * QT);
  return padded_words(W) <= fit ? padded_words(W) : (int)(fit / 32 * 32);
}

// Launch the grouped partial kernel of `Route` and the split merge (or the
// decode) on `stream`; `partial` holds (n_tiles, n_splits, NLISTS, k) keys
// on the shared-list path and (n_tiles, NLISTS, k) on the device-list one.
// Shared lists where k <= KSHARED and one tile's queries, lists, row rings
// and route scratch fit in shared memory: G = GROUP tiles per CTA where they
// fit for GROUP, else 1. Otherwise device lists with G = GROUP and the
// queries staged whole or in chunks (query_chunk_words). 16-byte loads where
// W % 4 == 0 and q, r are 16-byte aligned. Returns a cudaError_t.
template <class Route>
int launch_grouped(const void* q, const void* q_pmz, const void* q_charge, const void* r,
                   const void* r_pmz, const void* r_charge, const void* tile_start,
                   void* partial, void* std_sim, void* std_row, void* open_sim,
                   void* open_row, int n_tiles, int n_rows, int W, int dim, int k, int rk,
                   int n_splits, float std_scale, float open_tol, float pad_pmz,
                   cudaStream_t st) {
  if (k < 1 || n_splits < 1 || n_tiles < 1 || W < 1 || rk < 1 || n_splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto smem_for = [&](int G) {
    return sizeof(uint32_t) * G * QT * padded_words(W) + sizeof(winner_t) * G * NLISTS * k +
           RING_BYTES + Route::scratch_bytes(G);
  };
  const bool vec4 = W % 4 == 0 && reinterpret_cast<uintptr_t>(r) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 16 == 0;
  int rc;
#define REPRO_LAUNCH_GROUPED(G, V, GL, QW, SMEM)                                         \
  rc = launch_partial<Route, G, V, GL>(q, q_pmz, q_charge, r, r_pmz, r_charge, tile_start, \
                                       partial, n_tiles, n_rows, W, dim, k, rk, n_splits,  \
                                       std_scale, open_tol, pad_pmz, QW, SMEM, st)
  if (k <= KSHARED && smem_for(1) <= SMEM_BUDGET) {
    if (smem_for(GROUP) <= SMEM_BUDGET) {
      if (vec4)
        REPRO_LAUNCH_GROUPED(GROUP, 4, false, 0, smem_for(GROUP));
      else
        REPRO_LAUNCH_GROUPED(GROUP, 1, false, 0, smem_for(GROUP));
    } else {
      if (vec4)
        REPRO_LAUNCH_GROUPED(1, 4, false, 0, smem_for(1));
      else
        REPRO_LAUNCH_GROUPED(1, 1, false, 0, smem_for(1));
    }
    if (rc != 0) return rc;
    return launch_merge(partial, n_tiles, n_splits, k, std_sim, std_row, open_sim, open_row,
                        st);
  }
  const int qw = query_chunk_words(W, Route::scratch_bytes(GROUP));
  const size_t smem = sizeof(uint32_t) * GROUP * QT * qw + RING_BYTES +
                      Route::scratch_bytes(GROUP);
  cudaError_t e = cudaMemsetAsync(partial, 0, sizeof(winner_t) * n_tiles * NLISTS * (size_t)k,
                                  st);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (vec4)
    REPRO_LAUNCH_GROUPED(GROUP, 4, true, qw, smem);
  else
    REPRO_LAUNCH_GROUPED(GROUP, 1, true, qw, smem);
#undef REPRO_LAUNCH_GROUPED
  if (rc != 0) return rc;
  return launch_decode(partial, n_tiles, k, std_sim, std_row, open_sim, open_row, st);
}

}  // namespace
