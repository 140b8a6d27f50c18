// Bottom-up probe, the paper's LookingParents loop (Listing 1), for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/bottom_up_probe/kernel.py::bottom_up_probe_pallas
//   (body _probe_kernel).
// Same contract: for each vertex v with unvisited[v] != 0, probe positions
// pos < min(deg[v], max_pos) of its adjacency row; on the first neighbour
// u = col_idx[starts[v] + pos] whose frontier bit is set, write parent = u
// and found = 1. Otherwise found = 0 and parent passes through.
//
// Bound on the H100: memory bytes. Per vertex the kernel reads starts, deg,
// unvisited and parent and writes found and parent (24 bytes, coalesced);
// per probe round it gathers one 4-byte neighbour id and one 4-byte frontier
// word. There is no arithmetic to speak of.
//
// Design: one thread per vertex, grid-stride. A thread stops at its first
// hit, so a retired vertex issues no further gathers (the TPU kernel runs all
// max_pos rounds under a mask). Visited vertices load nothing beyond their
// flag and parent. The frontier bitmap is n/32 words (128 KiB at 2^20
// vertices) and stays resident in the 50 MB L2; it is read through the
// read-only data cache. Words are read as uint32_t so shifts are logical.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void bottom_up_probe_kernel(
    const int32_t* __restrict__ starts, const int32_t* __restrict__ deg,
    const int32_t* __restrict__ unvisited,
    const int32_t* __restrict__ parent_in,
    const int32_t* __restrict__ col_idx,
    const uint32_t* __restrict__ frontier_words,
    int32_t* __restrict__ found, int32_t* __restrict__ parent_out, int n,
    int num_words, int max_pos) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n; v += stride) {
    int32_t par = parent_in[v];
    int32_t hit = 0;
    if (unvisited[v] != 0) {
      const int32_t start = starts[v];
      const int32_t rounds = min(deg[v], max_pos);
      for (int pos = 0; pos < rounds; ++pos) {
        const uint32_t u = static_cast<uint32_t>(col_idx[start + pos]);
        const uint32_t word = u >> 5;
        if (word < static_cast<uint32_t>(num_words) &&
            ((__ldg(frontier_words + word) >> (u & 31u)) & 1u)) {
          par = static_cast<int32_t>(u);
          hit = 1;
          break;
        }
      }
    }
    found[v] = hit;
    parent_out[v] = par;
  }
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError().
extern "C" int bottom_up_probe_launch(
    const void* starts, const void* deg, const void* unvisited,
    const void* parent_in, const void* col_idx, const void* frontier_words,
    void* found, void* parent_out, int n, int num_words, int max_pos, int sms,
    void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = repro_torch::grid_blocks(n, threads, sms);
  bottom_up_probe_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(deg),
      static_cast<const int32_t*>(unvisited),
      static_cast<const int32_t*>(parent_in),
      static_cast<const int32_t*>(col_idx),
      static_cast<const uint32_t*>(frontier_words),
      static_cast<int32_t*>(found), static_cast<int32_t*>(parent_out), n,
      num_words, max_pos);
  return static_cast<int>(cudaGetLastError());
}
