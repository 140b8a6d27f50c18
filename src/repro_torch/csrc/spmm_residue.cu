// Residue fold of the ELL sum aggregation, for sm_90a: the adjacency slots
// at positions >= k_max of each row, added into ell_spmm's output.
//
// Stands in for the XLA segment_sum tail of
// src/repro/kernels/ell_spmm/ops.py::spmm_aggregate (lines 28-31); no
// Pallas kernel covers it. Contract, for each row v < n and column c < d:
//   y[v,c] += sum over pos in [k_max, deg_v), in slot order, of
//             x[clip(col_idx[row_ptr[v] + pos]), c]
// in place: y holds ell_spmm's slab sum on entry. The tail is summed on its
// own and added to y once, as the reference adds y + y_tail. Rows of degree
// <= k_max keep y. x is [n_src, d]; neighbour ids are clipped into
// [0, n_src).
//
// Bound on the H100: memory bytes. row_ptr is read once, each residue slot's
// neighbour id once with its neighbour's d-float row, and each residue row
// of y is read and written once.
//
// Design: a worker is S = min(32, pow2 >= d) threads of one warp, thread t
// owning columns t, t+S, ...; a grid-stride loop hands each worker whole
// rows, and a worker skips a row of degree <= k_max after reading its two
// row_ptr entries, so nothing is read back on the host to decide whether
// any row is that deep. A worker walks its row's tail in order: every
// thread reads the same id (one broadcast) and its columns of the
// neighbour's row, coalesced. No atomics: each output float has one
// writer, so two launches give the same bits. A hub row's whole tail falls
// to one worker; that is this kernel's known weakness on R-MAT graphs.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void spmm_residue_kernel(const int32_t* __restrict__ row_ptr,
                                    const int32_t* __restrict__ col_idx,
                                    const float* __restrict__ x,
                                    float* __restrict__ y, int n, int n_src,
                                    int d, int k_max, int sub, int chunks) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nworkers =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) / sub;
  const int t = static_cast<int>(tid % sub);
  for (int64_t row = tid / sub; row < n; row += nworkers) {
    const int64_t lo = static_cast<int64_t>(__ldg(row_ptr + row)) + k_max;
    const int64_t hi = __ldg(row_ptr + row + 1);
    if (lo >= hi) continue;
    for (int ch = 0; ch < chunks; ++ch) {
      const int c = ch * sub + t;
      if (c >= d) break;
      float acc = 0.0f;
#pragma unroll 4
      for (int64_t e = lo; e < hi; ++e) {
        int64_t u = __ldg(col_idx + e);
        u = u < 0 ? 0 : (u >= n_src ? n_src - 1 : u);
        acc += __ldg(x + u * d + c);
      }
      y[row * d + c] += acc;
    }
  }
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError(). x is [n_src, d] and y [n, d],
// row-major; row_ptr has n + 1 entries.
extern "C" int spmm_residue_launch(const void* row_ptr, const void* col_idx,
                                   const void* x, void* y, int n, int n_src,
                                   int d, int k_max, int sms, void* stream) {
  if (n <= 0 || d <= 0 || n_src <= 0) return 0;
  int sub = 1;
  while (sub < d && sub < 32) sub *= 2;
  const int chunks = (d + sub - 1) / sub;
  const int threads = 256;
  const int blocks = repro_torch::grid_blocks(
      static_cast<long long>(n) * sub, threads, sms);
  spmm_residue_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(col_idx), static_cast<const float*>(x),
      static_cast<float*>(y), n, n_src, d, k_max, sub, chunks);
  return static_cast<int>(cudaGetLastError());
}
