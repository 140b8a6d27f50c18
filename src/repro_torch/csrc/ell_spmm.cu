// ELL-slab sum aggregation (SpMM) for sm_90a.
//
// Replaces src/repro/kernels/ell_spmm/kernel.py::ell_spmm_pallas. Contract,
// for each row i < n and feature column c < d:
//   y[i,c] = sum over k < k_max, in slot order, of valid[i,k] ? x[neigh[i,k], c] : 0
// neigh is int32[n, k_max], valid bool[n, k_max] (one byte a slot), x is
// float32[n_src, d] and y float32[n, d], all row-major; n_src may differ
// from n. Padded slots (valid false, neighbour id n) are skipped without
// reading x; a valid id is clipped into [0, n_src) as the reference clips.
//
// Bound on the H100: memory bytes. Each row reads its k_max ids and flags
// once and each valid slot gathers one d-float row of x; y is written once.
// The Pallas kernel held all of x in VMEM; here x stays in device memory
// and the gathers go through L2, so any n_src fits.
//
// Design: a worker is S = min(32, pow2 >= d) threads of one warp, thread t
// owning columns t, t+S, ...; a grid-stride loop hands each worker whole
// rows. The S threads of a worker read each slot's id and flag at the same
// address (one broadcast) and gather the neighbour's row coalesced. Sums
// stay in registers, in slot order, and each output float is written once:
// no atomics, so two launches give the same bits.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void ell_spmm_kernel(const int32_t* __restrict__ neigh,
                                const uint8_t* __restrict__ valid,
                                const float* __restrict__ x,
                                float* __restrict__ y, int n, int n_src,
                                int d, int k_max, int sub, int chunks) {
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nworkers =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) / sub;
  const int t = static_cast<int>(tid % sub);
  for (int64_t row = tid / sub; row < n; row += nworkers) {
    const int32_t* ids = neigh + row * k_max;
    const uint8_t* ok = valid + row * k_max;
    for (int ch = 0; ch < chunks; ++ch) {
      const int c = ch * sub + t;
      if (c >= d) break;
      float acc = 0.0f;
#pragma unroll 4
      for (int k = 0; k < k_max; ++k) {
        if (__ldg(ok + k) == 0) continue;
        int64_t u = __ldg(ids + k);
        u = u < 0 ? 0 : (u >= n_src ? n_src - 1 : u);
        acc += __ldg(x + u * d + c);
      }
      y[row * d + c] = acc;
    }
  }
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError().
extern "C" int ell_spmm_launch(const void* neigh, const void* valid,
                               const void* x, void* y, int n, int n_src,
                               int d, int k_max, int sms, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  int sub = 1;
  while (sub < d && sub < 32) sub *= 2;
  const int chunks = (d + sub - 1) / sub;
  const int threads = 256;
  const int blocks = repro_torch::grid_blocks(
      static_cast<long long>(n) * sub, threads, sms);
  ell_spmm_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(neigh), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(x), static_cast<float*>(y), n, n_src, d,
      k_max, sub, chunks);
  return static_cast<int>(cudaGetLastError());
}
