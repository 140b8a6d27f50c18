// ELL-slab sum aggregation (SpMM) for sm_90a.
//
// Replaces src/repro/kernels/ell_spmm/kernel.py::ell_spmm_pallas. Contract,
// for each row i < n and feature column c < d:
//   y[i,c] = sum over k < k_max, in slot order, of valid[i,k] ? x[neigh[i,k], c] : 0
// neigh is int32[n, k_max], valid bool[n, k_max] (one byte a slot), x is
// float32[n_src, d] and y float32[n, d], all row-major; n_src may differ
// from n. Padded slots (valid false, neighbour id n) are skipped without
// reading x; a valid id is clipped into [0, n_src) as the reference clips.
// Each output float is a sum in slot order of plain float32 adds, the
// additions the plain version makes (it adds 0 for a padded slot, which
// leaves a sum that starts at +0 unchanged), so the two give the same bits.
//
// Bound on the H100: memory bytes. Each row reads its k_max ids and flags
// once and each valid slot gathers one d-float row of x; y is written once.
// The Pallas kernel held all of x in VMEM; here x stays in device memory
// and the gathers go through L2, so any n_src fits. At the GCN shapes x
// (157 MB at d = 16, 460 MB at d = 47) is larger than L2, so every valid
// slot is a random row gather from HBM, and what sets the time is how many
// of those gathers are in flight and how many 32-byte sectors each touches.
//
// Design: a worker is S threads of one warp that walks its row's slots once
// for all the row's columns: thread t holds column units t, t+S, .. in
// NACC accumulators, and wider rows loop over chunks of S * NACC units.
// Per 16 slots (or S, if larger) the worker reads the row's ids in one
// coalesced read (thread t the ids of slots t, t+S, ..) and its flags in
// the same way, gathered by one __ballot_sync; each slot's id goes round by
// __shfl_sync, and the gathers go out 8 slots back to back (predicated
// loads: a padded slot reads nothing) before their adds, in slot order.
// * A unit is a float4 (16-byte loads) where d % 4 == 0, d >= 16 and x is
//   16-byte aligned: S = min(32, pow2 >= d / 4), one accumulator. At d = 16
//   that is 4 threads a 64-byte row and 8 rows a warp.
// * Otherwise a unit is a float: a half-warp a row (S = 16, 2 rows a warp)
//   with up to 3 accumulators, columns t, t+16, t+32 at d = 47, held to 64
//   registers so that 4 blocks of 256 fit an SM.
// Sums stay in registers and each output float is written once: no
// atomics, so two launches give the same bits. The grid is capped at the
// blocks that can be resident at once (resident_blocks), so the grid-stride
// loop over rows runs in one wave.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int UNR = 8;  // gathers in flight a thread and accumulator

__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// V is float or float4; MINB the blocks an SM the registers must allow.
template <class V, int S, int NACC, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    ell_spmm_kernel(const int32_t* __restrict__ neigh,
                    const uint8_t* __restrict__ valid,
                    const float* __restrict__ x, float* __restrict__ y, int n,
                    int n_src, int units, int k_max) {
  constexpr int CH = S < 16 ? 16 : S;  // slots a coalesced id read
  constexpr int IPT = CH / S;          // ids a thread holds
  const int lane = threadIdx.x & 31;
  const int t = lane & (S - 1);
  const int gbase = lane & ~(S - 1);
  const V* xv = reinterpret_cast<const V*>(x);
  V* yv = reinterpret_cast<V*>(y);
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  // warps step over rows 32 / S at a time, so that every loop below is
  // uniform across the warp (the shuffles and ballots need all 32 threads)
  for (int64_t base =
           ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >>
            5) * (32 / S);
       base < n; base += nwarps * (32 / S)) {
    const int64_t row = base + lane / S;
    const bool active = row < n;
    const int32_t* ids = neigh + row * k_max;
    const uint8_t* ok = valid + row * k_max;
    for (int c0 = 0; c0 < units; c0 += S * NACC) {
      V acc[NACC];
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[a] = V{};
      for (int k0 = 0; k0 < k_max; k0 += CH) {
        int id[IPT];
        unsigned flags[IPT];
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
          const int k = k0 + t + i * S;
          const bool in = active && k < k_max;
          id[i] = in ? __ldg(ids + k) : 0;
          flags[i] = __ballot_sync(kFull, in && __ldg(ok + k) != 0);
        }
#pragma unroll
        for (int kb = 0; kb < CH; kb += UNR) {
          if (k0 + kb >= k_max) break;
          V v[UNR][NACC];
#pragma unroll
          for (int q = 0; q < UNR; ++q) {
            const int k = kb + q;  // slot k0 + k: held by thread k % S, as id[k / S]
            const int src = gbase + k % S;
            int u = __shfl_sync(kFull, id[k / S], src);
            u = u < 0 ? 0 : (u >= n_src ? n_src - 1 : u);
            const bool f = (flags[k / S] >> src) & 1u;
#pragma unroll
            for (int a = 0; a < NACC; ++a) {
              const int c = c0 + t + a * S;
              v[q][a] = f && c < units
                            ? __ldg(xv + static_cast<int64_t>(u) * units + c)
                            : V{};
            }
          }
#pragma unroll
          for (int q = 0; q < UNR; ++q)
#pragma unroll
            for (int a = 0; a < NACC; ++a) add(acc[a], v[q][a]);
        }
      }
      if (active)
#pragma unroll
        for (int a = 0; a < NACC; ++a) {
          const int c = c0 + t + a * S;
          if (c < units) yv[row * units + c] = acc[a];
        }
    }
  }
}

template <class V, int S, int NACC, int MINB = 1>
void launch(const void* neigh, const void* valid, const void* x, void* y,
            int n, int n_src, int units, int k_max, int sms,
            cudaStream_t stream) {
  auto kernel = ell_spmm_kernel<V, S, NACC, MINB>;
  const int blocks = repro_torch::resident_blocks(
      kernel, static_cast<long long>(n) * S, kThreads, sms);
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(neigh), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(x), static_cast<float*>(y), n, n_src, units,
      k_max);
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError(). y must be 16-byte aligned.
extern "C" int ell_spmm_launch(const void* neigh, const void* valid,
                               const void* x, void* y, int n, int n_src,
                               int d, int k_max, int sms, void* stream) {
  if (n <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && d >= 16 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
    const int nv = d / 4;
    if (nv <= 4)
      launch<float4, 4, 1>(neigh, valid, x, y, n, n_src, nv, k_max, sms, s);
    else if (nv <= 8)
      launch<float4, 8, 1>(neigh, valid, x, y, n, n_src, nv, k_max, sms, s);
    else if (nv <= 16)
      launch<float4, 16, 1>(neigh, valid, x, y, n, n_src, nv, k_max, sms, s);
    else
      launch<float4, 32, 1>(neigh, valid, x, y, n, n_src, nv, k_max, sms, s);
  } else if (d <= 16) {
    launch<float, 16, 1>(neigh, valid, x, y, n, n_src, d, k_max, sms, s);
  } else if (d <= 32) {
    launch<float, 16, 2>(neigh, valid, x, y, n, n_src, d, k_max, sms, s);
  } else {
    launch<float, 16, 3, 4>(neigh, valid, x, y, n, n_src, d, k_max, sms, s);
  }
  return static_cast<int>(cudaGetLastError());
}
