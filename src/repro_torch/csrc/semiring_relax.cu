// Masked min-plus (tropical) gather-relax over each row's first max_pos
// neighbours, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/semiring_relax/kernel.py::semiring_relax_pallas
//   (body _semiring_relax_kernel).
// Same contract: for each vertex v < n and lane l < L,
//   acc[v,l] = min over pos < min(deg[v], max_pos) of
//                vals[clip(col_idx[clip(starts[v] + pos)]), l] + w[clip(...)]
// and +inf where no position relaxes. vals is [nf, L] row-major with nf >= n
// (a local row block relaxes against full-range values); slots are clipped
// into [0, m) and neighbour ids into [0, nf), as the reference's gathers
// clip. Masking is by value: inactive sources hold +inf, excluded edges
// +inf weights. There is no retirement test: a later neighbour can always
// improve the minimum, so every live position is read. Inputs hold no NaN
// and no -inf (the weighted CSR refuses them), so fminf is the reference's
// min, and a position with a +inf weight adds +inf, which cannot lower it:
// its neighbour's values are not gathered at all.
//
// Bound on the H100: memory bytes. Per vertex: starts and deg, then per
// live position one neighbour id and one weight (4 + 4 bytes, the same for
// every lane) and, for a finite weight, the neighbour's L lane values; one
// write of L values.
// Arithmetic is one add and one min per value.
//
// Design: two mappings of the same loop, chosen from L by the launcher.
// * Warp per vertex (L > 8; the engine's 32 dense lanes): thread t holds
//   lanes t, t+32, ... . A round reads col_idx[e] and w[e] once for the
//   warp (every thread reads the same address: one broadcast transaction)
//   and, unless w[e] is +inf (the same test for the whole warp), the
//   neighbour's lane line coalesced (128 bytes at L = 32), then adds and
//   takes the min in a register. Vertices go grid-stride, one per warp and
//   pass.
// * Thread per vertex (L <= 8, e.g. the flat L = 1 plane): a warp per
//   vertex would leave 31 of 32 threads idle, so each thread walks its own
//   vertex and its L lanes.
// Both give the same bits: each output is a min of the same sums.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__device__ __forceinline__ int64_t clip64(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x >= hi ? hi - 1 : x);
}

__global__ void relax_warp_kernel(const int32_t* __restrict__ starts,
                                  const int32_t* __restrict__ deg,
                                  const int32_t* __restrict__ col_idx,
                                  const float* __restrict__ w,
                                  const float* __restrict__ vals,
                                  float* __restrict__ acc, int n, int nf,
                                  int lanes, long long m, int max_pos) {
  const int t = threadIdx.x & 31;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t v =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       v < n; v += nwarps) {
    const int64_t start = starts[v];
    const int rounds = min(deg[v], max_pos);
    for (int l = t; l - t < lanes; l += 32) {
      float a = INFINITY;
      for (int pos = 0; pos < rounds; ++pos) {
        const int64_t e = clip64(start + pos, m);
        const int64_t u = clip64(__ldg(col_idx + e), nf);
        const float we = __ldg(w + e);
        if (l < lanes && we != INFINITY)
          a = fminf(a, __ldg(vals + u * lanes + l) + we);
      }
      if (l < lanes) acc[v * lanes + l] = a;
    }
  }
}

__global__ void relax_thread_kernel(const int32_t* __restrict__ starts,
                                    const int32_t* __restrict__ deg,
                                    const int32_t* __restrict__ col_idx,
                                    const float* __restrict__ w,
                                    const float* __restrict__ vals,
                                    float* __restrict__ acc, int n, int nf,
                                    int lanes, long long m, int max_pos) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n; v += stride) {
    const int64_t start = starts[v];
    const int rounds = min(deg[v], max_pos);
    for (int l = 0; l < lanes; ++l) {
      float a = INFINITY;
      for (int pos = 0; pos < rounds; ++pos) {
        const int64_t e = clip64(start + pos, m);
        const int64_t u = clip64(__ldg(col_idx + e), nf);
        const float we = __ldg(w + e);
        if (we != INFINITY) a = fminf(a, __ldg(vals + u * lanes + l) + we);
      }
      acc[v * lanes + l] = a;
    }
  }
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError(). vals is [nf, lanes] and acc
// [n, lanes], row-major; m > 0.
extern "C" int semiring_relax_launch(const void* starts, const void* deg,
                                     const void* col_idx, const void* w,
                                     const void* vals, void* acc, int n,
                                     int nf, int lanes, long long m,
                                     int max_pos, int sms, void* stream) {
  if (n <= 0 || lanes <= 0 || m <= 0) return 0;
  const int threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes > 8) {
    const int blocks = repro_torch::grid_blocks(
        static_cast<long long>(n) * 32, threads, sms);
    relax_warp_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(deg),
        static_cast<const int32_t*>(col_idx), static_cast<const float*>(w),
        static_cast<const float*>(vals), static_cast<float*>(acc), n, nf,
        lanes, m, max_pos);
  } else {
    const int blocks = repro_torch::grid_blocks(n, threads, sms);
    relax_thread_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const int32_t*>(starts), static_cast<const int32_t*>(deg),
        static_cast<const int32_t*>(col_idx), static_cast<const float*>(w),
        static_cast<const float*>(vals), static_cast<float*>(acc), n, nf,
        lanes, m, max_pos);
  }
  return static_cast<int>(cudaGetLastError());
}
