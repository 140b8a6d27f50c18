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
// [nf, L] with nf >= n; neighbour ids are clipped into [0, nf).
//
// Bound on the H100: memory bytes. Each residue slot is read once (a 4-byte
// neighbour id and a 4-byte weight) with, for a finite weight, its
// neighbour's L lane values; each row with a residue is read and written
// once (at most).
//
// Design: the edge slots [row_ptr[0], row_ptr[n]) are cut into segments of
// SEG slots, whatever the rows, so every worker gets the same work however
// skewed the degrees are (an R-MAT hub with tens of thousands of neighbours
// spans many segments, where a warp per row would walk it alone). A worker
// is S = min(32, pow2 >= L) threads, thread t holding lanes t, t+S, ...;
// it finds its first slot's row in src_idx, walks the rows that overlap
// its segment through row_ptr (skipping each row's first max_pos slots
// without reading them), and for each row folds its slots into a register:
// every thread reads the same col_idx/w address (one broadcast) and, unless
// the weight is +inf (a candidate that cannot lower the min; the same test
// for every thread of the worker), its lane of the neighbour's value line.
// Inputs hold no NaN and no -inf. A row's partial min goes to out with
// one atomic min per lane, so a row split across segments merges in any
// order. Min is order-free, so the result is the same bits whatever the
// order. Partial mins of +inf (a lane masked out by +inf values or
// weights) are not written at all.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int SEG = 256;  // edge slots per segment

// Atomic float min by bit pattern: non-negative floats (+inf included)
// order like their bits as signed ints, negative floats in reverse as
// unsigned ints; the two cases together order every non-NaN float.
__device__ __forceinline__ void atomic_min_float(float* addr, float v) {
  if (v >= 0.0f)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__global__ void relax_fallback_kernel(const int32_t* __restrict__ row_ptr,
                                      const int32_t* __restrict__ src_idx,
                                      const int32_t* __restrict__ col_idx,
                                      const float* __restrict__ w,
                                      const float* __restrict__ vals,
                                      float* __restrict__ out, int n, int nf,
                                      int lanes, int max_pos, int sub,
                                      long long segments, int chunks) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t nworkers = (static_cast<int64_t>(gridDim.x) * blockDim.x) / sub;
  const int t = static_cast<int>(tid % sub);
  const int64_t e_begin = row_ptr[0];
  const int64_t e_end = row_ptr[n];
  for (int64_t item = tid / sub; item < segments * chunks; item += nworkers) {
    const int64_t seg = item / chunks;
    const int l = static_cast<int>(item % chunks) * sub + t;
    const bool live = l < lanes;
    int64_t e = e_begin + seg * SEG;
    const int64_t hi = e + SEG < e_end ? e + SEG : e_end;
    if (e >= hi) continue;
    int64_t r = src_idx[e];  // the row owning the segment's first slot
    if (r < 0) r = 0;
    while (e < hi && r < n) {
      const int64_t rs = row_ptr[r];
      const int64_t re = row_ptr[r + 1];
      const int64_t lo = e > rs + max_pos ? e : rs + max_pos;
      const int64_t top = hi < re ? hi : re;
      if (lo < top) {
        float a = INFINITY;
#pragma unroll 4
        for (int64_t k = lo; k < top; ++k) {
          int64_t u = __ldg(col_idx + k);
          u = u < 0 ? 0 : (u >= nf ? nf - 1 : u);
          const float wk = __ldg(w + k);
          if (live && wk != INFINITY)
            a = fminf(a, __ldg(vals + u * lanes + l) + wk);
        }
        if (live && a != INFINITY) atomic_min_float(out + r * lanes + l, a);
      }
      if (re > e) e = re;
      ++r;
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
  if (n <= 0 || lanes <= 0 || m <= 0) return 0;
  int sub = 1;
  while (sub < lanes && sub < 32) sub *= 2;
  const int chunks = (lanes + sub - 1) / sub;
  const long long segments = (m + SEG - 1) / SEG;
  const int threads = 256;
  const int blocks =
      repro_torch::grid_blocks(segments * chunks * sub, threads, sms);
  relax_fallback_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(src_idx),
      static_cast<const int32_t*>(col_idx), static_cast<const float*>(w),
      static_cast<const float*>(vals), static_cast<float*>(out), n, nf, lanes,
      max_pos, sub, segments, chunks);
  return static_cast<int>(cudaGetLastError());
}
