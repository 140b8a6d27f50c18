// Residue fold of the tropical gather-relax, for sm_90a: the edge slots at
// positions >= max_pos of each row, min-folded into the probe's result.
//
// Stands in for src/repro/traversal/semiring.py::_relax_fallback with the
// tropical segment_reduce it calls (an XLA associative_scan); no Pallas
// kernel covers it. Contract, for each row v < n and lane l < L:
//   out[v,l] = min(out[v,l], min over pos in [max_pos, deg_v) of
//                  vals[clip(col_idx[row_ptr[v] + pos]), l] + w[row_ptr[v] + pos])
// in place: out holds the base (semiring_relax's accumulator) on entry.
// Rows of degree <= max_pos, and empty rows, keep their base. vals is
// [nf, L] with nf >= n; neighbour ids are clipped into [0, nf); src_idx[e]
// is the row of slot e.
//
// Bound on the H100: memory bytes. Each residue slot is read once (a 4-byte
// neighbour id and a 4-byte weight) with, for a finite weight, its
// neighbour's L lane values; each row with a residue is read and written
// once (at most). In the engine's light relax about 97 % of the weights are
// +inf, so most slots gather nothing; in the heavy relax almost every slot
// gathers a 128-byte lane line, mostly from L2, and those gathers set the
// time.
//
// Design: the slots [row_ptr[0], row_ptr[n]) are cut into segments of SEG
// slots, whatever the rows, so every warp gets the same work however
// skewed the degrees are (an R-MAT hub spans many segments). A warp takes a
// segment, finds its first row in src_idx, reads the row_ptr entries of 32
// rows in one coalesced read and walks those rows' residue slots in the
// segment (the first max_pos slots of a row are skipped unread). Per 32
// slots of a row, each thread loads one slot's weight (one coalesced read);
// a chunk with no finite weight ends there, and otherwise the threads with
// a finite weight load their neighbour ids. A __ballot_sync of the finite
// weights leaves the live slots; their ids and weights go round by
// __shfl_sync and the warp gathers their lane lines (thread t holds lane t,
// t+32, .. of each) back to back: all 32 in a fixed order when every slot
// is live, else four at a time. Candidates vals + w are folded into a
// register min; at the row's end in the segment each lane goes to out by
// one atomic min on the float's bits. Min is order-free, so a row split
// across segments merges in any order and the result is the same bits as
// the plain version's; a partial min of +inf is not written at all. Inputs
// hold no NaN and no -inf. At most 40 registers a thread, so 6 blocks of
// 256 fit an SM, and the grid is capped at the blocks that can be resident
// at once (resident_blocks), so the grid-stride loop runs in one wave.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int SEG = 256;  // edge slots per segment
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clip_id(int u, int hi) {
  return u < 0 ? 0 : (u >= hi ? hi - 1 : u);
}

// Atomic float min by bit pattern: non-negative floats (+inf included)
// order like their bits as signed ints, negative floats in reverse as
// unsigned ints; the two cases together order every non-NaN float.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (v >= 0.0f)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void __launch_bounds__(256, 6)
    relax_fallback_kernel(const int32_t* __restrict__ row_ptr,
                          const int32_t* __restrict__ src_idx,
                          const int32_t* __restrict__ col_idx,
                          const float* __restrict__ w,
                          const float* __restrict__ vals,
                          float* __restrict__ out, int n, int nf, int lanes,
                          int max_pos, long long segments, int chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t e_begin = row_ptr[0];
  const int64_t e_end = row_ptr[n];
  for (int64_t item =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       item < segments * chunks; item += nwarps) {
    const int64_t a = e_begin + (item / chunks) * SEG;
    const int64_t b = a + SEG < e_end ? a + SEG : e_end;
    const int l = static_cast<int>(item % chunks) * 32 + lane;
    const bool own = l < lanes;
    int64_t r = a < b ? clip_id(__ldg(src_idx + a), n) : n;
    for (bool more = true; more && r < n; r += 32) {
      const int64_t rl = r + lane < n ? r + lane : n;
      const int lo_l = __ldg(row_ptr + rl);
      const int hi_l = __ldg(row_ptr + (rl < n ? rl + 1 : n));
      for (int i = 0; i < 32; ++i) {
        const int64_t rs = __shfl_sync(kFull, lo_l, i);
        const int64_t re = __shfl_sync(kFull, hi_l, i);
        if (r + i >= n || rs >= b) {
          more = false;
          break;
        }
        const int64_t lo = rs + max_pos > a ? rs + max_pos : a;
        const int64_t top = re < b ? re : b;
        float acc = INFINITY;
        for (int64_t base = lo; base < top; base += 32) {
          const int64_t e = base + lane;
          const float we = e < top ? __ldg(w + e) : INFINITY;
          unsigned mask = __ballot_sync(kFull, we != INFINITY);
          if (mask == 0) continue;
          const int u = we != INFINITY ? clip_id(__ldg(col_idx + e), nf) : 0;
          if (mask == kFull) {
#pragma unroll
            for (int jb = 0; jb < 32; jb += 8) {
              float cand[8];
#pragma unroll
              for (int q = 0; q < 8; ++q) {
                const int64_t uj = __shfl_sync(kFull, u, jb + q);
                const float wj = __shfl_sync(kFull, we, jb + q);
                cand[q] = own ? __ldg(vals + uj * lanes + l) + wj : INFINITY;
              }
#pragma unroll
              for (int q = 0; q < 8; ++q) acc = fminf(acc, cand[q]);
            }
            continue;
          }
          while (mask) {
            float cand[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const bool ok = mask != 0;
              const int j = ok ? __ffs(mask) - 1 : 0;
              mask &= mask - 1;
              const int64_t uj = __shfl_sync(kFull, u, j);
              const float wj = __shfl_sync(kFull, we, j);
              cand[q] =
                  ok && own ? __ldg(vals + uj * lanes + l) + wj : INFINITY;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) acc = fminf(acc, cand[q]);
          }
        }
        if (own && acc != INFINITY)
          atomic_min_float(out + (r + i) * lanes + l, acc);
      }
    }
  }
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError(). vals is [nf, lanes] and out
// [n, lanes], row-major; m is the length of col_idx, src_idx and w.
extern "C" int relax_fallback_launch(const void* row_ptr, const void* src_idx,
                                     const void* col_idx, const void* w,
                                     const void* vals, void* out, int n,
                                     int nf, int lanes, long long m,
                                     int max_pos, int sms, void* stream) {
  if (n <= 0 || lanes <= 0 || m <= 0 || nf <= 0) return 0;
  const int chunks = (lanes + 31) / 32;
  const long long segments = (m + SEG - 1) / SEG;
  const int threads = 256;
  const int blocks = repro_torch::resident_blocks(
      relax_fallback_kernel, segments * chunks * 32, threads, sms);
  relax_fallback_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(src_idx),
      static_cast<const int32_t*>(col_idx), static_cast<const float*>(w),
      static_cast<const float*>(vals), static_cast<float*>(out), n, nf, lanes,
      max_pos, segments, chunks);
  return static_cast<int>(cudaGetLastError());
}
