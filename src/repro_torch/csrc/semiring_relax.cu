// Masked min-plus (tropical) gather-relax over each row's first max_pos
// neighbours, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/semiring_relax/kernel.py::semiring_relax_pallas
//   (body _semiring_relax_kernel).
// Same contract: for each vertex v < n and lane l < L,
//   acc[v,l] = min over pos < min(deg[v], max_pos) of
//                vals[clip(col_idx[clip(starts[v] + pos)]), l] + w[clip(...)]
// and +inf where no position relaxes, with starts[v] = row_ptr[v] and
// deg[v] = row_ptr[v+1] - row_ptr[v]. vals is [nf, L] row-major with
// nf >= n (a local row block relaxes against full-range values); slots are
// clipped into [0, m) and neighbour ids into [0, nf), as the reference's
// gathers clip. Masking is by value: inactive sources hold +inf, excluded
// edges +inf weights. There is no retirement test: a later neighbour can
// always improve the minimum, so every live position is read. Inputs hold
// no NaN and no -inf (the weighted CSR refuses them), so fminf is the
// reference's min, and a position with a +inf weight adds +inf, which
// cannot lower it: its neighbour's values are not gathered at all. A min is
// the same bits in any order of the slots.
//
// Bound on the H100: memory bytes. Per vertex its row_ptr entry, per live
// position one neighbour id and one weight and, for a finite weight, the
// neighbour's L lane values (a 128-byte line at L = 32, a random gather
// from a 134 MB vals that L2 does not hold); one write of L values. In the
// engine's light relax about 97 % of the weights are +inf, so the acc write
// sets the time; in the heavy relax the lane-line gathers do. Arithmetic is
// one add and one min per value.
//
// What limits a kernel here is how many of those trips to memory are in
// flight, not the bytes: a warp that walked one vertex's slots one after
// another would wait on a dependent id load, then a gather, per slot.
// Design, two mappings chosen from L by the launcher:
// * A probe list per warp (L > 8; the engine's 32 dense lanes). A warp takes
//   32 consecutive vertices: one coalesced read of their row_ptr entries and
//   an exclusive prefix over their probe counts (__shfl_up_sync) give a
//   list of at most 32 * max_pos probe slots. The warp reads the list 32
//   slots at a time (thread t finds its slot's vertex by a binary search
//   over the prefix, by __shfl_sync, and loads that slot's weight and id in
//   one coalesced read); a __ballot_sync of the finite weights leaves the
//   live slots, whose lane lines go out G = 16 gathers back to back (thread
//   t holds lane t, t+32, .. of each). Running minima stay in shared memory,
//   one 32 x 32 tile a warp in which thread t owns column t, so no two
//   threads touch one word; each acc line is written once, coalesced, at
//   the end of the tile. A chunk with no finite weight (most of the light
//   relax) ends at its ballot.
// * Thread per vertex (L <= 8, e.g. the flat L = 1 plane): a warp per 32
//   vertices would leave most lanes of each lane line idle, so each thread
//   walks its own vertex and its L lanes.
// Both grids are capped at the blocks that can be resident at once
// (resident_blocks), so each grid-stride loop runs in one wave. Both give
// the same bits.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int G = 16;  // lane-line gathers in flight a warp

__device__ __forceinline__ int64_t clip64(int64_t x, int64_t hi) {
  return x < 0 ? 0 : (x >= hi ? hi - 1 : x);
}

__device__ __forceinline__ int clip_id(int u, int hi) {
  return u < 0 ? 0 : (u >= hi ? hi - 1 : u);
}

__global__ void __launch_bounds__(kThreads)
    relax_list_kernel(const int32_t* __restrict__ row_ptr,
                      const int32_t* __restrict__ col_idx,
                      const float* __restrict__ w,
                      const float* __restrict__ vals, float* __restrict__ acc,
                      int n, int nf, int lanes, long long m, int max_pos) {
  __shared__ float tile[kWarps][32][32];
  float(*s)[32] = tile[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t v0 =
           ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >>
            5) * 32;
       v0 < n; v0 += nwarps * 32) {
    const int64_t vl = v0 + lane < n ? v0 + lane : n;
    const int lo_l = __ldg(row_ptr + vl);
    const int hi_l = __ldg(row_ptr + (vl < n ? vl + 1 : n));
    const int nv = n - v0 < 32 ? static_cast<int>(n - v0) : 32;
    const int cnt = lane < nv ? min(hi_l - lo_l, max_pos) : 0;
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int excl = incl - cnt;
    const int total = __shfl_sync(kFull, incl, 31);
    for (int lc = 0; lc < lanes; lc += 32) {
      const int l = lc + lane;
      const bool own = l < lanes;
#pragma unroll
      for (int j = 0; j < 32; ++j) s[j][lane] = INFINITY;
      for (int s0 = 0; s0 < total; s0 += 32) {
        const int sidx = s0 + lane;
        // the slot's vertex: the last j with excl[j] <= sidx
        int jv = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int pe = __shfl_sync(kFull, excl, jv + step);
          if (pe <= sidx) jv += step;
        }
        const int ex = __shfl_sync(kFull, excl, jv);
        const int st = __shfl_sync(kFull, lo_l, jv);
        const int64_t e = clip64(static_cast<int64_t>(st) + (sidx - ex), m);
        const bool in = sidx < total;
        const float we = in ? __ldg(w + e) : INFINITY;
        const int u = in ? clip_id(__ldg(col_idx + e), nf) : 0;
        unsigned mask = __ballot_sync(kFull, we != INFINITY);
        while (mask) {
          float cand[G];
          int jq[G];
#pragma unroll
          for (int q = 0; q < G; ++q) {
            const bool ok = mask != 0;
            const int src = ok ? __ffs(mask) - 1 : 0;
            mask &= mask - 1;
            const int64_t uq = __shfl_sync(kFull, u, src);
            const float wq = __shfl_sync(kFull, we, src);
            jq[q] = __shfl_sync(kFull, jv, src);
            cand[q] =
                ok && own ? __ldg(vals + uq * lanes + l) + wq : INFINITY;
          }
#pragma unroll
          for (int q = 0; q < G; ++q)
            s[jq[q]][lane] = fminf(s[jq[q]][lane], cand[q]);
        }
      }
      if (own)
        for (int j = 0; j < nv; ++j) acc[(v0 + j) * lanes + l] = s[j][lane];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    relax_thread_kernel(const int32_t* __restrict__ row_ptr,
                        const int32_t* __restrict__ col_idx,
                        const float* __restrict__ w,
                        const float* __restrict__ vals,
                        float* __restrict__ acc, int n, int nf, int lanes,
                        long long m, int max_pos) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n; v += stride) {
    const int64_t start = row_ptr[v];
    const int rounds = min(row_ptr[v + 1] - row_ptr[v], max_pos);
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
// synchronise; returns cudaGetLastError(). row_ptr has n + 1 entries, vals
// is [nf, lanes] and acc [n, lanes], row-major; m > 0.
extern "C" int semiring_relax_launch(const void* row_ptr, const void* col_idx,
                                     const void* w, const void* vals,
                                     void* acc, int n, int nf, int lanes,
                                     long long m, int max_pos, int sms,
                                     void* stream) {
  if (n <= 0 || lanes <= 0 || m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = lanes > 8 ? relax_list_kernel : relax_thread_kernel;
  // the list kernel takes a warp per 32 vertices: a thread per vertex too
  const long long threads_needed =
      lanes > 8 ? (static_cast<long long>(n) + 31) / 32 * 32 : n;
  const int blocks =
      repro_torch::resident_blocks(kernel, threads_needed, kThreads, sms);
  kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(col_idx), static_cast<const float*>(w),
      static_cast<const float*>(vals), static_cast<float*>(acc), n, nf, lanes,
      m, max_pos);
  return static_cast<int>(cudaGetLastError());
}
