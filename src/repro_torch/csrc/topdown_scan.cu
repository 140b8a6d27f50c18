// Top-down edge scan fused with the scatter-min by destination, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/topdown_scan/kernel.py::topdown_scan_pallas
//   (body _scan_kernel),
// together with the scatter-min that follows it outside the kernel
// (src/repro/kernels/topdown_scan/ops.py::topdown_step_pallas). For each edge
// slot e with u = src_idx[e] in the frontier and v = col_idx[e] not visited,
// best[v] = min(best[v], u). The caller fills best with n first. Min does not
// depend on the order of the updates, so the result is deterministic and
// equal to the reference's scatter-min.
//
// Bound on the H100: memory bytes. The scan reads src_idx (4 bytes per edge
// slot) and, for edges whose source is in the frontier, col_idx (4 more);
// the two bitmaps are n/32 words each (128 KiB at 2^20 vertices) and stay in
// L2.
//
// Design: one thread per edge slot, grid-stride, consecutive threads on
// consecutive slots so the src_idx loads coalesce. src_idx is sorted (the
// CSR row expansion), so the threads of a warp mostly test the same frontier
// word. col_idx and the visited word are loaded only for edges whose source
// is in the frontier: in a sparse top-down layer most warps skip those loads
// entirely. On the TPU the scatter stayed outside the kernel because
// cross-tile scatters race there; here atomicMin on int32 does it in place.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__device__ __forceinline__ bool bit_set(const uint32_t* __restrict__ words,
                                        int num_words, uint32_t id) {
  const uint32_t word = id >> 5;
  return word < static_cast<uint32_t>(num_words) &&
         ((__ldg(words + word) >> (id & 31u)) & 1u);
}

__global__ void topdown_scan_kernel(
    const int32_t* __restrict__ src_idx, const int32_t* __restrict__ col_idx,
    const uint32_t* __restrict__ frontier_words,
    const uint32_t* __restrict__ visited_words, int32_t* __restrict__ best,
    int64_t m, int n, int frontier_num_words, int visited_num_words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < m; e += stride) {
    const uint32_t u = static_cast<uint32_t>(src_idx[e]);
    if (!bit_set(frontier_words, frontier_num_words, u)) continue;
    const uint32_t v = static_cast<uint32_t>(col_idx[e]);
    if (v >= static_cast<uint32_t>(n) ||
        bit_set(visited_words, visited_num_words, v))
      continue;
    atomicMin(best + v, static_cast<int32_t>(u));
  }
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError().
extern "C" int topdown_scan_launch(const void* src_idx, const void* col_idx,
                                   const void* frontier_words,
                                   const void* visited_words, void* best,
                                   long long m, int n, int frontier_num_words,
                                   int visited_num_words, int sms,
                                   void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  const int blocks = repro_torch::grid_blocks(m, threads, sms);
  topdown_scan_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src_idx),
      static_cast<const int32_t*>(col_idx),
      static_cast<const uint32_t*>(frontier_words),
      static_cast<const uint32_t*>(visited_words),
      static_cast<int32_t*>(best), m, n, frontier_num_words,
      visited_num_words);
  return static_cast<int>(cudaGetLastError());
}
