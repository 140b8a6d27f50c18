// Word-packed multi-source bottom-up probe, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/msbfs_probe/kernel.py::msbfs_probe_pallas
//   (body _msbfs_probe_kernel).
// Same contract: for each vertex v and lane-word plane p, for pos <
// min(deg[v], max_pos), while (need[v,p] & ~acc[v,p]) != 0,
//   acc[v,p] |= frontier[col_idx[starts[v] + pos], p].
// Retirement is per plane, so acc is bit-equal to the reference's, not only
// acc & need. frontier has nf >= n rows (a local row block probes the full
// frontier); a neighbour id outside [0, nf) gathers nothing.
//
// Bound on the H100: memory bytes. Per vertex the kernel reads starts, deg
// and W need words and writes W acc words (coalesced); per live round it
// gathers one 4-byte neighbour id and that neighbour's live frontier words.
// Arithmetic is a few bitwise operations per word.
//
// Design: one thread per vertex, grid-stride, the W planes in a loop inside
// the thread. On the TPU W is an outer grid dimension, so col_idx is
// gathered again for every plane; here a round gathers the neighbour id
// once for all planes that are still live and reads that neighbour's words,
// which sit side by side in the row-major [nf, W] layout (8 bytes at W = 2).
// A thread leaves the round loop once no plane is live. Planes go in chunks
// of CW registers (CW = 1, 2, 4 or 8, chosen from W by the launcher). The
// frontier is n*W*4 bytes (8 MB at 2^20 vertices and 64 lanes, 32 MB at
// 256) and stays in the 50 MB L2; it is read through the read-only cache.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

template <int CW>
__global__ void msbfs_probe_kernel(const int32_t* __restrict__ starts,
                                   const int32_t* __restrict__ deg,
                                   const uint32_t* __restrict__ need,
                                   const int32_t* __restrict__ col_idx,
                                   const uint32_t* __restrict__ frontier,
                                   uint32_t* __restrict__ acc_out, int n,
                                   int nf, int w, long long m, int max_pos) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n; v += stride) {
    const int64_t start = starts[v];
    const int rounds = min(deg[v], max_pos);
    const uint32_t* need_v = need + v * w;
    uint32_t* acc_v = acc_out + v * w;
    for (int w0 = 0; w0 < w; w0 += CW) {
      uint32_t nd[CW];
      uint32_t acc[CW];
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        nd[j] = (w0 + j < w) ? need_v[w0 + j] : 0u;
        acc[j] = 0u;
      }
      for (int pos = 0; pos < rounds; ++pos) {
        bool live = false;
#pragma unroll
        for (int j = 0; j < CW; ++j) live |= (nd[j] & ~acc[j]) != 0u;
        if (!live) break;
        int64_t e = start + pos;  // the reference clips the slot into [0, m)
        e = e < 0 ? 0 : (e >= m ? m - 1 : e);
        const uint32_t u = static_cast<uint32_t>(col_idx[e]);
        if (u >= static_cast<uint32_t>(nf)) continue;
        const uint32_t* fu = frontier + static_cast<int64_t>(u) * w + w0;
#pragma unroll
        for (int j = 0; j < CW; ++j)
          if ((nd[j] & ~acc[j]) != 0u) acc[j] |= __ldg(fu + j);
      }
#pragma unroll
      for (int j = 0; j < CW; ++j)
        if (w0 + j < w) acc_v[w0 + j] = acc[j];
    }
  }
}

template <int CW>
void launch(const void* starts, const void* deg, const void* need,
            const void* col_idx, const void* frontier, void* acc, int n,
            int nf, int w, long long m, int max_pos, int blocks, int threads,
            cudaStream_t stream) {
  msbfs_probe_kernel<CW><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(deg),
      static_cast<const uint32_t*>(need),
      static_cast<const int32_t*>(col_idx),
      static_cast<const uint32_t*>(frontier), static_cast<uint32_t*>(acc),
      n, nf, w, m, max_pos);
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError(). need and acc are [n, w] and
// frontier [nf, w], row-major.
extern "C" int msbfs_probe_launch(const void* starts, const void* deg,
                                  const void* need, const void* col_idx,
                                  const void* frontier, void* acc, int n,
                                  int nf, int w, long long m, int max_pos,
                                  int sms, void* stream) {
  if (n <= 0 || w <= 0 || m <= 0) return 0;
  const int threads = 256;
  const int blocks = repro_torch::grid_blocks(n, threads, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 1)
    launch<1>(starts, deg, need, col_idx, frontier, acc, n, nf, w, m, max_pos,
              blocks, threads, s);
  else if (w == 2)
    launch<2>(starts, deg, need, col_idx, frontier, acc, n, nf, w, m, max_pos,
              blocks, threads, s);
  else if (w <= 4)
    launch<4>(starts, deg, need, col_idx, frontier, acc, n, nf, w, m, max_pos,
              blocks, threads, s);
  else
    launch<8>(starts, deg, need, col_idx, frontier, acc, n, nf, w, m, max_pos,
              blocks, threads, s);
  return static_cast<int>(cudaGetLastError());
}
