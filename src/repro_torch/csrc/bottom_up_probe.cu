// Bottom-up probe, the paper's LookingParents loop (Listing 1), for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/bottom_up_probe/kernel.py::bottom_up_probe_pallas
//   (body _probe_kernel).
// Same contract: for each vertex v with unvisited[v] != 0, probe positions
// pos < min(deg[v], max_pos) of its adjacency row in order, deg[v] =
// row_ptr[v + 1] - row_ptr[v]; on the first neighbour u = col_idx[row_ptr[v]
// + pos] whose frontier bit is set, write parent = u and found = 1.
// Otherwise found = 0 and parent passes through. Ids at or past 32 *
// num_words never hit. The parent is the hit at the lowest position, not
// the lowest id. unvisited is the step's bool flags, one byte a vertex.
//
// Bound on the H100: memory bytes. Per vertex the kernel reads its flag and
// parent and writes found and parent (coalesced); an unvisited vertex reads
// its row bounds and, per probe, one neighbour id and one frontier word.
// There is no arithmetic to speak of.
//
// Design: one thread per vertex, grid-stride, the grid capped at the blocks
// that can be resident at once (resident_blocks). A thread's flag, row
// bounds and parent are loaded together. Its probes go in groups: first
// kFirst positions, then kGroup at a time, with the stop on a hit between
// groups; inside a group every id is loaded before any frontier word, and
// the first hit in position order is picked in registers. So a vertex walks
// at most two dependent id-then-word trips for max_pos = 8, where a loop
// of one probe at a time walks up to eight; the small first group keeps
// the speculative loads few where most vertices hit at once (the late
// bottom-up layers, whose frontier is dense), and the later group's ids lie
// in the line the first group's loads brought into L1. Of one group of 8
// and first groups of 1 or 2 (PERF.md), 2 + 6 was the fastest on every
// input measured. The frontier bitmap is n/32 words (128 KiB at 2^20
// vertices) and stays resident in the 50 MB L2; it is read through the
// read-only data cache. Words are read as uint32_t so shifts are logical.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFirst = 2;  // probe positions in the first group
constexpr int kGroup = 6;  // probe positions in each later group
constexpr uint32_t kNone = 0xffffffffu;  // no slot: its word index is past
                                         // any bitmap

__global__ void __launch_bounds__(kThreads)
    bottom_up_probe_kernel(const int32_t* __restrict__ row_ptr,
                           const uint8_t* __restrict__ unvisited,
                           const int32_t* __restrict__ parent_in,
                           const int32_t* __restrict__ col_idx,
                           const uint32_t* __restrict__ frontier_words,
                           int32_t* __restrict__ found,
                           int32_t* __restrict__ parent_out, int n,
                           int num_words, int max_pos) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n; v += stride) {
    const bool unv = unvisited[v] != 0;
    const int start = row_ptr[v];
    const int end = row_ptr[v + 1];
    int32_t par = parent_in[v];
    int32_t hit = 0;
    const int rounds = unv ? min(end - start, max_pos) : 0;
    for (int pos = 0; pos < rounds && !hit;) {
      const int group = pos == 0 ? kFirst : kGroup;
      uint32_t u[kGroup], word[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        u[j] = j < group && pos + j < rounds
                   ? static_cast<uint32_t>(__ldg(col_idx + start + pos + j))
                   : kNone;
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        word[j] = (u[j] >> 5) < static_cast<uint32_t>(num_words)
                      ? __ldg(frontier_words + (u[j] >> 5))
                      : 0u;
#pragma unroll
      for (int j = kGroup - 1; j >= 0; --j)  // the lowest position wins
        if ((word[j] >> (u[j] & 31u)) & 1u) {
          par = static_cast<int32_t>(u[j]);
          hit = 1;
        }
      pos += group;
    }
    found[v] = hit;
    parent_out[v] = par;
  }
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError(). row_ptr has n + 1 entries.
extern "C" int bottom_up_probe_launch(
    const void* row_ptr, const void* unvisited, const void* parent_in,
    const void* col_idx, const void* frontier_words, void* found,
    void* parent_out, int n, int num_words, int max_pos, int sms,
    void* stream) {
  if (n <= 0) return 0;
  const int blocks = repro_torch::resident_blocks(bottom_up_probe_kernel, n,
                                                  kThreads, sms);
  bottom_up_probe_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr),
      static_cast<const uint8_t*>(unvisited),
      static_cast<const int32_t*>(parent_in),
      static_cast<const int32_t*>(col_idx),
      static_cast<const uint32_t*>(frontier_words),
      static_cast<int32_t*>(found), static_cast<int32_t*>(parent_out), n,
      num_words, max_pos);
  return static_cast<int>(cudaGetLastError());
}
