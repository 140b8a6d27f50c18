// Residue fold of the ELL sum aggregation, for sm_90a: the adjacency slots
// at positions >= k_max of each row, added into ell_spmm's output.
//
// Stands in for the XLA segment_sum tail of
// src/repro/kernels/ell_spmm/ops.py::spmm_aggregate (lines 28-31); no
// Pallas kernel covers it. Contract, for each row v < n and column c < d:
//   y[v,c] += sum over pos in [k_max, deg_v) of
//             x[clip(col_idx[row_ptr[v] + pos]), c]
// in place: y holds ell_spmm's slab sum on entry. The tail is summed on its
// own and added to y once, as the reference adds y + y_tail. Rows of degree
// <= k_max keep y. x is [n_src, d]; neighbour ids are clipped into
// [0, n_src). src_idx[e] is the row of slot e.
//
// Bound on the H100: memory bytes. row_ptr is read once, each residue slot's
// neighbour id once with its neighbour's d-float row, and each residue row
// of y is read and written once. Each slot gathers its own row of an x that
// L2 does not hold (157 MB at ogb_products d = 16), so the random row
// gathers set the time, not the arithmetic.
//
// Design, three launches on the caller's stream, no host read-back and no
// float atomics. A worker is S = min(32, pow2 >= d) threads, thread t
// owning columns t, t+S, .. (C <= 4 accumulators, so all of a row's columns
// are summed in one walk; wider rows take one more launch pair per 4S
// columns). Per 32 tail slots a worker loads the 32 neighbour ids in one
// coalesced read, passes each on by __shfl_sync and issues its gathers back
// to back.
// * Short tails (<= LONG_TAIL slots, every row of the ogb_products batch): a
//   worker per row, rows grid-stride, each summed in slot order and added
//   to y.
// * Long tails (hubs: 138,274 slots on scale-20 R-MAT): the slots
//   [row_ptr[0], row_ptr[n]) are cut into segments of `seg` slots, fixed by
//   the slot index whatever the rows, and a warp takes a segment. It finds
//   its first row in src_idx, reads the row_ptr entries of 32 rows in one
//   coalesced read and walks the long rows among them. The warp is 32 / S
//   groups that gather alternate slots; their sums meet by a fixed
//   __shfl_xor_sync butterfly. A long row whose tail lies in one segment is
//   added to y there; a row split across segments leaves its partial in
//   `part`: slot 2s+1 for the segment where its tail starts (its row number
//   in part_row[s]), slot 2s for each later segment it continues into.
// * Merge: a warp per segment with a row in part_row adds that row's
//   partials in segment order, then adds the sum to y once.
// Each output float has one writer and every sum has a fixed order, so two
// launches on the same inputs give the same bits. Grids are capped at the
// blocks that can be resident at once (resident_blocks), so a grid-stride
// loop runs in one wave.
// Scratch: part holds 2 * segments * d floats and part_row segments int32s,
// segments = ceil(m / seg); every segment writes its part_row entry, so
// neither needs clearing.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int LONG_TAIL = 64;  // longer tails go to the segment pass

__device__ __forceinline__ int clip_id(int u, int hi) {
  return u < 0 ? 0 : (u >= hi ? hi - 1 : u);
}

// Short tails, columns [c0, c0 + S * C): a worker of S threads per row.
template <int S, int C>
__global__ void residue_rows_kernel(const int32_t* __restrict__ row_ptr,
                                    const int32_t* __restrict__ col_idx,
                                    const float* __restrict__ x,
                                    float* __restrict__ y, int n, int n_src,
                                    int d, int c0, int k_max) {
  constexpr int K = 32 / S;  // ids a thread loads a round (32 a worker)
  const int lane = threadIdx.x & 31;
  const int t = lane % S;
  const unsigned wmask =
      S == 32 ? kFull : ((1u << S) - 1u) << (lane / S * S);  // its lanes
  const int col = c0 + t;
  const int64_t nworkers = (static_cast<int64_t>(gridDim.x) * blockDim.x) / S;
  for (int64_t row =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / S;
       row < n; row += nworkers) {
    const int64_t lo = static_cast<int64_t>(__ldg(row_ptr + row)) + k_max;
    const int64_t top = __ldg(row_ptr + row + 1);
    if (lo >= top || top - lo > LONG_TAIL) continue;
    float acc[C];
#pragma unroll
    for (int k = 0; k < C; ++k) acc[k] = 0.0f;
    for (int64_t base = lo; base < top; base += 32) {
      const int cnt = top - base < 32 ? static_cast<int>(top - base) : 32;
      int u[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = t + k * S;
        u[k] = j < cnt ? clip_id(__ldg(col_idx + base + j), n_src) : 0;
      }
#pragma unroll
      for (int jb = 0; jb < 32; jb += 8) {
        if (jb >= cnt) break;
#pragma unroll
        for (int j = jb; j < jb + 8; ++j) {
          const int64_t uj = __shfl_sync(wmask, u[j / S], j % S, S);
          if (j < cnt) {
            const float* xr = x + uj * d + col;
#pragma unroll
            for (int k = 0; k < C; ++k)
              if (col + k * S < d) acc[k] += __ldg(xr + k * S);
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (col + k * S < d) y[row * d + col + k * S] += acc[k];
  }
}

// Long tails, columns [c0, c0 + S * C): a warp per segment of slots.
template <int S, int C>
__global__ void residue_segments_kernel(
    const int32_t* __restrict__ row_ptr, const int32_t* __restrict__ src_idx,
    const int32_t* __restrict__ col_idx, const float* __restrict__ x,
    float* __restrict__ y, float* __restrict__ part,
    int32_t* __restrict__ part_row, int n, int n_src, int d, int c0,
    int k_max, long long segments, int seg) {
  constexpr int G = 32 / S;  // groups of a warp, gathering alternate slots
  const int lane = threadIdx.x & 31;
  const int g = lane / S;
  const int col = c0 + lane % S;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t e_begin = row_ptr[0];
  const int64_t e_end = row_ptr[n];
  for (int64_t s =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       s < segments; s += nwarps) {
    const int64_t a = e_begin + s * seg;
    const int64_t b = a + seg < e_end ? a + seg : e_end;
    int out_row = -1;
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
        const int64_t t0 = rs + k_max;
        if (re - t0 <= LONG_TAIL) continue;  // a short tail: done by rows
        const int64_t lo = t0 > a ? t0 : a;
        const int64_t top = re < b ? re : b;
        if (lo >= top) continue;
        float acc[C];
#pragma unroll
        for (int k = 0; k < C; ++k) acc[k] = 0.0f;
        for (int64_t base = lo; base < top; base += 32) {
          const int cnt = top - base < 32 ? static_cast<int>(top - base) : 32;
          const int u = lane < cnt ? clip_id(__ldg(col_idx + base + lane),
                                             n_src)
                                   : 0;
#pragma unroll
          for (int q = 0; q < S; ++q) {
            const int j = q * G + g;
            const int64_t uj = __shfl_sync(kFull, u, j);
            if (j < cnt) {
              const float* xr = x + uj * d + col;
#pragma unroll
              for (int k = 0; k < C; ++k)
                if (col + k * S < d) acc[k] += __ldg(xr + k * S);
            }
          }
        }
#pragma unroll
        for (int off = S; off < 32; off <<= 1)
#pragma unroll
          for (int k = 0; k < C; ++k)
            acc[k] += __shfl_xor_sync(kFull, acc[k], off);
        const int64_t row = r + i;
        float* dst = nullptr;  // the whole tail is here: add it to y
        if (t0 < a) {
          dst = part + 2 * s * d;  // continues a row split before a
        } else if (re > b) {
          dst = part + (2 * s + 1) * d;  // starts a row split at b
          out_row = static_cast<int>(row);
        }
        if (g == 0) {
#pragma unroll
          for (int k = 0; k < C; ++k) {
            const int c = col + k * S;
            if (c >= d) continue;
            if (dst)
              dst[c] = acc[k];
            else
              y[row * d + c] += acc[k];
          }
        }
      }
    }
    if (lane == 0) part_row[s] = out_row;
  }
}

// Adds each split row's partials in segment order, then adds them to y.
__global__ void residue_merge_kernel(const int32_t* __restrict__ row_ptr,
                                     const float* __restrict__ part,
                                     const int32_t* __restrict__ part_row,
                                     float* __restrict__ y, int d,
                                     long long segments, int seg) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t e_begin = row_ptr[0];
  for (int64_t s =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       s < segments; s += nwarps) {
    const int64_t r = __ldg(part_row + s);
    if (r < 0) continue;
    const int64_t last = (__ldg(row_ptr + r + 1) - 1 - e_begin) / seg;
    for (int c = lane; c < d; c += 32) {
      float acc = __ldg(part + (2 * s + 1) * d + c);
#pragma unroll 8
      for (int64_t q = s + 1; q <= last; ++q)
        acc += __ldg(part + 2 * q * d + c);
      y[r * d + c] += acc;
    }
  }
}

template <int S, int C>
void launch_columns(int sms, cudaStream_t st, const int32_t* row_ptr,
                    const int32_t* src_idx, const int32_t* col_idx,
                    const float* x, float* y, float* part, int32_t* part_row,
                    int n, int n_src, int d, int c0, int k_max,
                    long long segments, int seg) {
  residue_rows_kernel<S, C><<<repro_torch::resident_blocks(
                                  residue_rows_kernel<S, C>,
                                  static_cast<long long>(n) * S, 256, sms),
                              256, 0, st>>>(row_ptr, col_idx, x, y, n, n_src,
                                            d, c0, k_max);
  residue_segments_kernel<S, C><<<repro_torch::resident_blocks(
                                      residue_segments_kernel<S, C>,
                                      segments * 32, 256, sms),
                                  256, 0, st>>>(
      row_ptr, src_idx, col_idx, x, y, part, part_row, n, n_src, d, c0,
      k_max, segments, seg);
}

}  // namespace

// Launches the three passes on `stream` of the current device, which has
// `sms` SMs; does not synchronise; returns cudaGetLastError() and sets
// *launches to the kernels it launched (a row and a segment pass per
// 4 * S columns, then the merge). x is [n_src, d] and y [n, d], row-major;
// row_ptr has n + 1 entries; part holds 2 * segments * d floats and
// part_row segments int32s, with segments * seg >= row_ptr[n] - row_ptr[0].
// Slots at row_ptr[n] and beyond (dead slots) are never read: the row pass
// stops at each row's end and the segment pass at row_ptr[n].
extern "C" int spmm_residue_launch(const void* row_ptr, const void* src_idx,
                                   const void* col_idx, const void* x,
                                   void* y, void* part, void* part_row, int n,
                                   int n_src, int d, int k_max,
                                   long long segments, int seg, int sms,
                                   void* stream, int* launches) {
  *launches = 0;
  if (n <= 0 || d <= 0 || n_src <= 0 || segments <= 0) return 0;
  const auto* rp = static_cast<const int32_t*>(row_ptr);
  const auto* si = static_cast<const int32_t*>(src_idx);
  const auto* ci = static_cast<const int32_t*>(col_idx);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  auto* pf = static_cast<float*>(part);
  auto* pr = static_cast<int32_t*>(part_row);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int sub = 1;
  while (sub < d && sub < 32) sub *= 2;
  const int acc = (d + sub - 1) / sub < 4 ? (d + sub - 1) / sub : 4;
  for (int c0 = 0; c0 < d; c0 += sub * acc) {
#define REPRO_COLUMNS(S, C)                                                 \
  launch_columns<S, C>(sms, st, rp, si, ci, xf, yf, pf, pr, n, n_src, d, c0, \
                       k_max, segments, seg)
    switch (sub * 8 + acc) {
      case 1 * 8 + 1: REPRO_COLUMNS(1, 1); break;
      case 2 * 8 + 1: REPRO_COLUMNS(2, 1); break;
      case 4 * 8 + 1: REPRO_COLUMNS(4, 1); break;
      case 8 * 8 + 1: REPRO_COLUMNS(8, 1); break;
      case 16 * 8 + 1: REPRO_COLUMNS(16, 1); break;
      case 32 * 8 + 1: REPRO_COLUMNS(32, 1); break;
      case 32 * 8 + 2: REPRO_COLUMNS(32, 2); break;
      case 32 * 8 + 3: REPRO_COLUMNS(32, 3); break;
      default: REPRO_COLUMNS(32, 4); break;
    }
#undef REPRO_COLUMNS
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    *launches += 2;
  }
  residue_merge_kernel<<<repro_torch::resident_blocks(residue_merge_kernel,
                                                      segments * 32, 256, sms),
                         256, 0, st>>>(rp, pf, pr, yf, d, segments, seg);
  const int err = static_cast<int>(cudaGetLastError());
  if (err == 0) *launches += 1;
  return err;
}
