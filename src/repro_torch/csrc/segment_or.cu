// Fused row-parallel lane-word OR of the packed BFS steps, for sm_90a.
//
// Stands in for the XLA segmented-OR scan
//   src/repro/core/packed.py::segment_or (a lax.associative_scan),
// with the gather before it and the masks after it, in both packed steps
// (topdown_packed_step and the fallback of bottomup_packed_step). No Pallas
// kernel covers it. Contract, for each row v and lane word p:
//   out[v,p] = base[v,p] | (mask[v,p] & OR over pos in [min_pos, deg_v) of
//                 (frontier[clip(col_idx[row_ptr[v] + pos]), p] & sel[p]))
//                                                       if row_active[v]
//   out[v,p] = base[v,p]                                otherwise
// sel == nullptr selects every lane, base == nullptr is 0, row_active ==
// nullptr makes every row active. Neighbour ids are clipped into [0, nf),
// as the reference's gather does.
//
// Bound on the H100: memory bytes. An active row reads its slice of col_idx
// (coalesced) and gathers W frontier words per edge; every row reads its row
// bounds, mask and base and writes W words. Top-down reads all m neighbour
// ids; the bottom-up fallback only the residue rows' tails.
//
// Design: one warp per row, grid-stride over rows. R-MAT degrees are very
// skewed (a few rows have tens of thousands of neighbours at scale 20), so
// a thread per row would leave one thread walking a long row while its warp
// waits. The 32 lanes stride over [min_pos, deg) reading consecutive
// neighbour ids, OR the words into registers per plane, and the warp
// reduces each plane with __reduce_or_sync; one lane writes. An inactive
// row costs one flag read and its base copy, so the bottom-up fallback runs
// without first asking the host whether any row needs it. The frontier
// (n*W*4 bytes, 8 MB at 2^20 vertices and 64 lanes) stays in L2 and is read
// through the read-only cache.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

template <int CW>
__global__ void segment_or_kernel(const int32_t* __restrict__ row_ptr,
                                  const int32_t* __restrict__ col_idx,
                                  const uint32_t* __restrict__ frontier,
                                  const uint32_t* __restrict__ mask,
                                  const uint32_t* __restrict__ sel,
                                  const uint32_t* __restrict__ base,
                                  const int32_t* __restrict__ row_active,
                                  uint32_t* __restrict__ out, int n, int nf,
                                  int w, int min_pos) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t v =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       v < n; v += nwarps) {
    // v is the same for all lanes of the warp, so every branch on the row
    // below is warp-uniform and the full-mask reductions are safe
    const bool active = row_active == nullptr || row_active[v] != 0;
    const int64_t start = static_cast<int64_t>(row_ptr[v]) + min_pos;
    const int64_t end = row_ptr[v + 1];
    for (int w0 = 0; w0 < w; w0 += CW) {
      uint32_t acc[CW];
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[j] = 0u;
      if (active && start < end) {
        uint32_t s[CW];
#pragma unroll
        for (int j = 0; j < CW; ++j)
          s[j] = (w0 + j < w) ? (sel == nullptr ? ~0u : sel[w0 + j]) : 0u;
        for (int64_t e = start + lane; e < end; e += 32) {
          int32_t u = col_idx[e];
          u = u < 0 ? 0 : (u >= nf ? nf - 1 : u);
          const uint32_t* fu = frontier + static_cast<int64_t>(u) * w + w0;
#pragma unroll
          for (int j = 0; j < CW; ++j)
            if (s[j] != 0u) acc[j] |= __ldg(fu + j) & s[j];
        }
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[j] = __reduce_or_sync(0xffffffffu, acc[j]);
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          if (w0 + j < w) {
            const int64_t i = v * w + w0 + j;
            const uint32_t b = base == nullptr ? 0u : base[i];
            out[i] = b | (mask[i] & acc[j]);
          }
        }
      }
    }
  }
}

template <int CW>
void launch(const void* row_ptr, const void* col_idx, const void* frontier,
            const void* mask, const void* sel, const void* base,
            const void* row_active, void* out, int n, int nf, int w,
            int min_pos, int blocks, int threads, cudaStream_t stream) {
  segment_or_kernel<CW><<<blocks, threads, 0, stream>>>(
      static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(col_idx),
      static_cast<const uint32_t*>(frontier),
      static_cast<const uint32_t*>(mask), static_cast<const uint32_t*>(sel),
      static_cast<const uint32_t*>(base),
      static_cast<const int32_t*>(row_active), static_cast<uint32_t*>(out), n,
      nf, w, min_pos);
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError(). mask, base and out are [n, w] and
// frontier [nf, w], row-major; sel has w words.
extern "C" int segment_or_launch(const void* row_ptr, const void* col_idx,
                                 const void* frontier, const void* mask,
                                 const void* sel, const void* base,
                                 const void* row_active, void* out, int n,
                                 int nf, int w, int min_pos, int sms,
                                 void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const int threads = 256;  // 8 warps, one row each per pass
  const int blocks =
      repro_torch::grid_blocks(static_cast<long long>(n) * 32, threads, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 1)
    launch<1>(row_ptr, col_idx, frontier, mask, sel, base, row_active, out, n,
              nf, w, min_pos, blocks, threads, s);
  else if (w == 2)
    launch<2>(row_ptr, col_idx, frontier, mask, sel, base, row_active, out, n,
              nf, w, min_pos, blocks, threads, s);
  else if (w <= 4)
    launch<4>(row_ptr, col_idx, frontier, mask, sel, base, row_active, out, n,
              nf, w, min_pos, blocks, threads, s);
  else
    launch<8>(row_ptr, col_idx, frontier, mask, sel, base, row_active, out, n,
              nf, w, min_pos, blocks, threads, s);
  return static_cast<int>(cudaGetLastError());
}
