// Graph500 parents from multi-source BFS depths, for sm_90a.
//
// Stands in for the XLA gathers and scatter-min of
//   src/repro/core/msbfs.py::_derive_parents
// (per lane chunk: depth[col] and depth[src] gathered to [m, chunk], a
// compare, a where, and .at[src].min). No Pallas kernel covers it. Contract,
// for each row v in [0, n_loc) (global row base + v) and lane l < r:
//   out[v,l] = min { u = col_idx[e] : e in [row_ptr[v], row_ptr[v+1]),
//                    0 <= u < n, depth[u,l] >= 0,
//                    depth[u,l] + 1 == depth[base+v,l] }    (-1 if none)
// with depth int32[n, r] in [-1, 253] (the engines cap it at MAX_TRACE).
// A column outside [0, n), as the sentinel n of a block's pad slot, never
// wins. Roots are seated by the caller.
//
// Bound on the H100: memory bytes. The depths are read once (n r 4 bytes),
// col_idx once (4 m), a neighbour's lanes once per edge slot, and the
// parents written once (n_loc r 4). The chunked library version writes and
// reads [m, chunk] int32 buffers: at scale 20, 64 lanes, 16 gathers of
// 1.07 GB a call.
//
// Design. Two launches. The narrowing pass writes each row's depths as one
// byte a lane, padded to `stride` bytes (16, 32, 64 or a multiple of 128;
// pad lanes read -1): 64 lanes are 64 bytes a row, 67 MB at n = 2^20, so
// the rows that R-MAT gathers most stay in L2, and one edge slot costs a
// 64-byte line instead of 64 int32 gathers. The scan pass gives a row to a
// warp. A group of G threads covers a lane block of 4G bytes (a thread 4
// lanes, one 4-byte load); the 32 / G groups of the warp take a round's
// neighbours in turns, kUnroll loads in flight each. A thread holds its
// lanes' targets, depth - 1 a byte (0xfe, which no depth narrows to, where
// the depth is 0 or -1), compares a neighbour's four bytes at once
// (__vcmpeq4) and keeps a min of the neighbour id per lane in registers;
// the groups' mins meet by shuffles. A row none of whose lanes has a target
// (unreached, or only roots) reads no neighbour. A row of more than `seg`
// slots does its first seg slots and lists the rest as segments; the
// segment launch gives each to a warp, whose mins reach `out` through an
// unsigned atomicMin (-1 is the largest unsigned value, so "none" loses,
// and a min gives the same answer in any order). Lane blocks of 128 lanes
// past the first are the grid's y dimension.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;                   // neighbour loads in flight
constexpr unsigned kNone = 0xffffffffu;      // no parent: -1 as int32
constexpr uint32_t kNoTarget = 0xfefefefeu;  // no narrowed depth is 0xfe

// A slice of one long row: slots [begin, min(begin + seg, row end)).
struct Segment {
  int v;
  int begin;
};

__global__ void __launch_bounds__(kThreads)
    parents_narrow_kernel(const int32_t* __restrict__ depth,
                          uint32_t* __restrict__ narrow, long long n, int r,
                          int words) {
  const long long total = n * words;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long v = i / words;
    const int lane0 = 4 * static_cast<int>(i - v * words);
    const int32_t* row = depth + v * r;
    uint32_t x = 0u;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = lane0 + k;
      const uint32_t b = l < r ? static_cast<uint32_t>(__ldg(row + l)) & 0xffu
                               : 0xffu;
      x |= b << (8 * k);
    }
    narrow[i] = x;
  }
}

// The lanes' targets from the row's own narrowed depths: depth - 1 a byte,
// kNoTarget's byte where the depth is 0 (a root) or -1 (unreached).
__device__ __forceinline__ uint32_t targets(uint32_t own) {
  const uint32_t zero = __vcmpeq4(own, 0u);
  return (__vsub4(own, 0x01010101u) & ~zero) | (kNoTarget & zero);
}

// Slots [lo, hi) of one row against the targets: best[k] = min(best[k],
// u) over the neighbours u whose byte k of the thread's word equals the
// target's. Called by the whole warp.
template <int G>
__device__ __forceinline__ void scan_slots(
    const int32_t* __restrict__ col_idx, const uint32_t* __restrict__ narrow,
    int lo, int hi, int n, int words, int word, uint32_t tgt,
    unsigned (&best)[4]) {
  constexpr int kGroups = 32 / G;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  for (int e0 = lo; e0 < hi; e0 += 32) {
    const int cnt = hi - e0 < 32 ? hi - e0 : 32;
    const int mine = lane < cnt ? __ldg(col_idx + e0 + lane) : -1;
    for (int j0 = 0; j0 < cnt; j0 += kGroups * kUnroll) {
      int u[kUnroll];
      uint32_t x[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int j = j0 + q * kGroups + grp;
        u[q] = __shfl_sync(kFull, mine, j & 31);
        const bool ok = j < cnt && u[q] >= 0 && u[q] < n;
        x[q] = ok ? __ldg(narrow + static_cast<int64_t>(u[q]) * words + word)
                  : 0xffffffffu;  // matches no target
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const unsigned hit = __vcmpeq4(x[q], tgt);
        if (hit != 0u) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (hit & (0xffu << (8 * k)))
              best[k] = min(best[k], static_cast<unsigned>(u[q]));
        }
      }
    }
  }
}

// The groups' mins meet in group 0.
template <int G>
__device__ __forceinline__ void min_over_groups(unsigned (&best)[4]) {
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      best[k] = min(best[k], __shfl_xor_sync(kFull, best[k], off));
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    parents_rows_kernel(const int32_t* __restrict__ row_ptr,
                        const int32_t* __restrict__ col_idx,
                        const uint32_t* __restrict__ narrow,
                        int32_t* __restrict__ out, int n_loc, int n,
                        int base, int r, int words, int seg,
                        Segment* __restrict__ segs,
                        int* __restrict__ num_segs) {
  const int lane = threadIdx.x & 31;
  const int word = blockIdx.y * G + lane % G;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t v =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       v < n_loc; v += nwarps) {
    const int lo = row_ptr[v];
    const int end = row_ptr[v + 1];
    const uint32_t tgt = targets(
        __ldg(narrow + (base + v) * static_cast<int64_t>(words) + word));
    unsigned best[4] = {kNone, kNone, kNone, kNone};
    if (__any_sync(kFull, tgt != kNoTarget))
      scan_slots<G>(col_idx, narrow, lo, end - lo > seg ? lo + seg : end, n,
                    words, word, tgt, best);
    if (blockIdx.y == 0 && end - lo > seg) {
      // the slots past the first seg, as segments for the second launch
      const int ns = (end - lo - 1) / seg;
      int first = 0;
      if (lane == 0) first = atomicAdd(num_segs, ns);
      first = __shfl_sync(kFull, first, 0);
      for (int k = lane; k < ns; k += 32)
        segs[first + k] = Segment{static_cast<int>(v), lo + (k + 1) * seg};
    }
    min_over_groups<G>(best);
    if (lane < G) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = 4 * word + k;
        if (l < r) out[v * r + l] = static_cast<int32_t>(best[k]);
      }
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
    parents_segments_kernel(const int32_t* __restrict__ row_ptr,
                            const int32_t* __restrict__ col_idx,
                            const uint32_t* __restrict__ narrow,
                            int32_t* __restrict__ out, int n, int base, int r,
                            int words, int seg,
                            const Segment* __restrict__ segs,
                            const int* __restrict__ num_segs) {
  const int lane = threadIdx.x & 31;
  const int word = blockIdx.y * G + lane % G;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int total = *num_segs;
  for (int64_t k =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       k < total; k += nwarps) {
    const Segment sg = segs[k];
    const uint32_t tgt = targets(__ldg(
        narrow + (base + static_cast<int64_t>(sg.v)) * words + word));
    if (!__any_sync(kFull, tgt != kNoTarget)) continue;
    const int end = row_ptr[sg.v + 1];
    unsigned best[4] = {kNone, kNone, kNone, kNone};
    scan_slots<G>(col_idx, narrow, sg.begin,
                  end - sg.begin > seg ? sg.begin + seg : end, n, words, word,
                  tgt, best);
    min_over_groups<G>(best);
    if (lane < G) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int l = 4 * word + j;
        if (l < r && best[j] != kNone)
          atomicMin(reinterpret_cast<unsigned*>(out) +
                        static_cast<int64_t>(sg.v) * r + l,
                    best[j]);
      }
    }
  }
}

template <int G>
void scan(const int32_t* row_ptr, const int32_t* col_idx,
          const uint32_t* narrow, int32_t* out, int n_loc, int n, int base,
          int r, int words, int seg, long long max_segs, Segment* segs,
          int* num_segs, int sms, cudaStream_t stream) {
  const int blocks_y = words / G;
  auto rows = parents_rows_kernel<G>;
  int bx = repro_torch::resident_blocks(
      rows, static_cast<long long>(n_loc) * 32, kThreads, sms);
  bx = bx / blocks_y > 0 ? bx / blocks_y : 1;
  rows<<<dim3(bx, blocks_y), kThreads, 0, stream>>>(
      row_ptr, col_idx, narrow, out, n_loc, n, base, r, words, seg, segs,
      num_segs);
  auto tails = parents_segments_kernel<G>;
  bx = repro_torch::resident_blocks(tails, max_segs * 32, kThreads, sms);
  bx = bx / blocks_y > 0 ? bx / blocks_y : 1;
  tails<<<dim3(bx, blocks_y), kThreads, 0, stream>>>(
      row_ptr, col_idx, narrow, out, n, base, r, words, seg, segs, num_segs);
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns the first CUDA error. depth is int32 [n, r]
// row-major; narrow is [n, stride] bytes, stride a multiple of 16 and at
// least r.
extern "C" int derive_parents_narrow_launch(const void* depth, void* narrow,
                                            long long n, int r, int stride,
                                            int sms, void* stream) {
  if (n <= 0) return 0;
  const int words = stride / 4;
  const int blocks = repro_torch::resident_blocks(parents_narrow_kernel,
                                                  n * words, kThreads, sms);
  parents_narrow_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(depth), static_cast<uint32_t*>(narrow), n,
      r, words);
  return static_cast<int>(cudaGetLastError());
}

// out is int32 [n_loc, r] row-major; narrow [n, stride] bytes from the
// narrowing launch, stride 16, 32, 64 or a multiple of 128; rows [base,
// base + n_loc) of it are the block's own. scratch holds the segment list:
// an int count, an int of padding, then max_segs (row, begin) pairs,
// max_segs > m / seg (a row of c > seg slots lists ceil(c / seg) - 1).
extern "C" int derive_parents_scan_launch(const void* row_ptr,
                                          const void* col_idx,
                                          const void* narrow, void* out,
                                          int n_loc, int n, int base, int r,
                                          int stride, int seg,
                                          long long max_segs, void* scratch,
                                          int sms, void* stream) {
  if (n_loc <= 0 || r <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* num_segs = static_cast<int*>(scratch);
  cudaError_t err = cudaMemsetAsync(num_segs, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Segment* segs = reinterpret_cast<Segment*>(num_segs + 2);
  const int words = stride / 4;
  auto go = [&](auto g) {
    scan<decltype(g)::value>(
        static_cast<const int32_t*>(row_ptr),
        static_cast<const int32_t*>(col_idx),
        static_cast<const uint32_t*>(narrow), static_cast<int32_t*>(out),
        n_loc, n, base, r, words, seg, max_segs, segs, num_segs, sms, s);
  };
  if (words == 4)
    go(std::integral_constant<int, 4>());
  else if (words == 8)
    go(std::integral_constant<int, 8>());
  else if (words == 16)
    go(std::integral_constant<int, 16>());
  else
    go(std::integral_constant<int, 32>());
  return static_cast<int>(cudaGetLastError());
}
