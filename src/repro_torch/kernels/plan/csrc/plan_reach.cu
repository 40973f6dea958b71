// The device planner's reach (repro_torch.kernels.plan.ref.plan_reach, the
// plain version): over queries sorted by (charge, pmz), the most library
// blocks one q-block segment of a charge run reaches under the open window.
// It replaces no Pallas kernel: the reference plans on the host with numpy
// (repro/core/search.py::plan_search), and this kernel returns that plan's
// count for the port's core/search.py::plan_search_device.
//
// Design: one thread a query. A thread whose query ends its segment (the
// last of its charge run, or the q_block-th from the run's start) finds
// the run's start by a binary search over the sorted charges, takes
// lo = first pmz - tol and hi = its pmz + tol in float32 as numpy does, and
// counts its blocks as (min keys <= (charge, hi)) - (max keys <
// (charge, lo)) by two binary searches over the sorted int64 pair keys.
// A warp reduces its maximum with shuffles and one lane folds it into the
// output with atomicMax; the launcher zeroes the output first. The work is
// a few binary searches a segment (~1,000 segments a run of 16,000), so
// the launch, not the card, sets its time.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCtas = 1024;

// The pair key of ref.pair_key: the charge above 32 bits, below them the
// float's bits made monotone, -0.0 read as +0.0.
__device__ __forceinline__ long long pair_key(int charge, float x) {
  int b = __float_as_int(__fadd_rn(x, 0.0f));
  b ^= (b >> 31) & 0x7FFFFFFF;
  return static_cast<long long>(charge) * 4294967296LL + b;
}

// First index in a[0, n) whose value is >= v (or > v when `upper`).
template <typename T>
__device__ __forceinline__ int bound(const T* a, int n, T v, bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const T m = a[mid];
    if (m < v || (upper && m == v)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void plan_reach_kernel(const float* __restrict__ qp,
                                  const int* __restrict__ qc,
                                  const long long* __restrict__ kmin,
                                  const long long* __restrict__ kmax,
                                  int* __restrict__ out, int Q, int n_blocks,
                                  int q_block, float tol) {
  int best = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < Q;
       i += gridDim.x * blockDim.x) {
    const int c = qc[i];
    const int run_start = bound(qc, Q, c, false);
    const bool last = i + 1 == Q || qc[i + 1] != c || (i + 1 - run_start) % q_block == 0;
    if (!last) continue;
    const int first = i - (i - run_start) % q_block;
    const float lo = __fsub_rn(qp[first], tol);
    const float hi = __fadd_rn(qp[i], tol);
    const int reach = bound(kmin, n_blocks, pair_key(c, hi), true) -
                      bound(kmax, n_blocks, pair_key(c, lo), false);
    best = max(best, reach);
  }
  for (int off = 16; off > 0; off >>= 1)
    best = max(best, __shfl_down_sync(0xffffffffu, best, off));
  if ((threadIdx.x & 31) == 0 && best > 0) atomicMax(out, best);
}

}  // namespace

extern "C" int plan_reach_launch(const void* qp, const void* qc, const void* kmin,
                                 const void* kmax, void* out, int Q, int n_blocks,
                                 int q_block, float tol, void* stream) {
  if (Q < 1 || n_blocks < 0 || q_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  int ctas = (Q + kThreads - 1) / kThreads;
  if (ctas > kMaxCtas) ctas = kMaxCtas;
  plan_reach_kernel<<<ctas, kThreads, 0, st>>>(
      static_cast<const float*>(qp), static_cast<const int*>(qc),
      static_cast<const long long*>(kmin), static_cast<const long long*>(kmax),
      static_cast<int*>(out), Q, n_blocks, q_block, tol);
  return static_cast<int>(cudaGetLastError());
}
