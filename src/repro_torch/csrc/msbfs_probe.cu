// Word-packed multi-source bottom-up probe, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/msbfs_probe/kernel.py::msbfs_probe_pallas
//   (body _msbfs_probe_kernel).
// Same contract: for each vertex v and lane-word plane p, for pos <
// min(deg[v], max_pos), while (need[v,p] & ~acc[v,p]) != 0,
//   acc[v,p] |= frontier[col_idx[clip(row_ptr[v] + pos)], p],
// with deg[v] = row_ptr[v + 1] - row_ptr[v] and the slot clipped into
// [0, m). Retirement is per plane, so acc is bit-equal to the reference's,
// not only acc & need. frontier has nf >= n rows (a local row block probes
// the full frontier); a neighbour id outside [0, nf) gathers nothing, but
// its round still counts.
//
// Bound on the H100: memory bytes. Per vertex the kernel reads W need words
// and writes W acc words (coalesced); a vertex with a needed lane reads its
// row bounds and, per live round, one 4-byte neighbour id and that
// neighbour's live frontier words. Arithmetic is a few bitwise operations
// per word.
//
// Design: one thread per vertex, grid-stride, the grid capped at the blocks
// that can be resident at once (resident_blocks); the W planes go in chunks
// of CW registers (CW = 1, 2, 4 or 8, chosen from W by the launcher). A
// thread loads its row bounds and its first chunk of need together; a
// vertex with no slot or no needed lane (most of them in a late layer)
// writes zeros and loads nothing more. Its rounds go in groups of kGroup
// positions, with the stop between groups once no plane is live. Inside a
// group every neighbour id is loaded once, for all planes, before any
// frontier word; then each chunk of planes gathers its words of the
// group's rows (one 8-byte load a row at W = 2, 16-byte loads where CW = 4
// or 8 divides W and the frontier is aligned for it) and applies the rule
// in position order in registers, so a word gathered past its plane's
// retirement is never ORed in. So a vertex walks one dependent id-then-row
// trip for max_pos = 8, where a loop of one round at a time walks up to
// eight. At W > CW the ids stay in registers across the chunks, and acc
// carries over in the output row between groups. At CW <= 2 the kernel is
// held to 64 registers (4 blocks an SM), which it fits without spilling;
// wider chunks need their registers. Smaller first groups (1 or 2, then the
// rest) gather less in the late layers, where planes retire early, and lose
// more in the early ones (PERF.md). The frontier is n*W*4 bytes (8 MB at
// 2^20 vertices and 64 lanes, 32 MB at 256) and stays in the 50 MB L2; it
// is read through the read-only cache.
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // probe positions a group
constexpr uint32_t kNone = 0xffffffffu;  // no slot: past any frontier row

__device__ __forceinline__ int64_t clip_slot(int64_t e, long long m) {
  return e < 0 ? 0 : (e >= m ? m - 1 : e);
}

// Words [w0, w0 + CW) of frontier row u (rows w words apart), 0 past w and
// for u outside [0, nf). Vector loads when vec (CW divides w, aligned).
template <int CW>
__device__ __forceinline__ void row_words(const uint32_t* __restrict__ f,
                                          uint32_t u, int nf, int w, int w0,
                                          bool vec, uint32_t (&x)[CW]) {
  if (u >= static_cast<uint32_t>(nf)) {
#pragma unroll
    for (int k = 0; k < CW; ++k) x[k] = 0u;
    return;
  }
  const uint32_t* p = f + static_cast<int64_t>(u) * w + w0;
  if (CW == 2 && vec) {
    const uint2 y = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = y.x;
    x[1 % CW] = y.y;
  } else if (CW >= 4 && vec) {
#pragma unroll
    for (int k = 0; k < CW; k += 4) {
      const uint4 y = __ldg(reinterpret_cast<const uint4*>(p + k));
      x[k % CW] = y.x;
      x[(k + 1) % CW] = y.y;
      x[(k + 2) % CW] = y.z;
      x[(k + 3) % CW] = y.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CW; ++k) x[k] = w0 + k < w ? __ldg(p + k) : 0u;
  }
}

template <int CW>
__global__ void __launch_bounds__(kThreads, CW <= 2 ? 4 : 1)
    msbfs_probe_kernel(const int32_t* __restrict__ row_ptr,
                       const uint32_t* __restrict__ need,
                       const int32_t* __restrict__ col_idx,
                       const uint32_t* __restrict__ frontier,
                       uint32_t* __restrict__ acc_out, int n, int nf, int w,
                       long long m, int max_pos, bool vec) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n; v += stride) {
    const int start = row_ptr[v];
    const int rounds = min(row_ptr[v + 1] - start, max_pos);
    const uint32_t* need_v = need + v * w;
    uint32_t* acc_v = acc_out + v * w;
    uint32_t need0[CW];
    bool needed = w > CW;  // past the first chunk: not looked at here
#pragma unroll
    for (int k = 0; k < CW; ++k) {
      need0[k] = k < w ? need_v[k] : 0u;
      needed |= need0[k] != 0u;
    }
    if (rounds <= 0 || !needed) {
      for (int k = 0; k < w; ++k) acc_v[k] = 0u;
      continue;
    }
    bool live = true;
    for (int pos = 0; pos < rounds && live; pos += kGroup) {
      uint32_t u[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        u[j] = pos + j < rounds
                   ? static_cast<uint32_t>(
                         __ldg(col_idx + clip_slot(start + pos + j, m)))
                   : kNone;
      live = false;
      for (int w0 = 0; w0 < w; w0 += CW) {
        uint32_t nd[CW], acc[CW];
#pragma unroll
        for (int k = 0; k < CW; ++k) {
          nd[k] = w0 == 0 ? need0[k] : (w0 + k < w ? need_v[w0 + k] : 0u);
          acc[k] = pos == 0 || w0 + k >= w ? 0u : acc_v[w0 + k];
        }
        uint32_t x[kGroup][CW];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          row_words<CW>(frontier, u[j], nf, w, w0, vec, x[j]);
#pragma unroll
        for (int j = 0; j < kGroup; ++j)  // in position order
#pragma unroll
          for (int k = 0; k < CW; ++k)
            if (nd[k] & ~acc[k]) acc[k] |= x[j][k];
#pragma unroll
        for (int k = 0; k < CW; ++k) {
          if (w0 + k < w) acc_v[w0 + k] = acc[k];
          live |= (nd[k] & ~acc[k]) != 0u;
        }
      }
    }
  }
}

template <int CW>
void launch(const void* row_ptr, const void* need, const void* col_idx,
            const void* frontier, void* acc, int n, int nf, int w,
            long long m, int max_pos, int sms, cudaStream_t stream) {
  const bool vec = CW > 1 && w % CW == 0 &&
                   reinterpret_cast<uintptr_t>(frontier) %
                           (4 * CW > 16 ? 16 : 4 * CW) ==
                       0;
  auto kernel = msbfs_probe_kernel<CW>;
  kernel<<<repro_torch::resident_blocks(kernel, n, kThreads, sms), kThreads,
           0, stream>>>(static_cast<const int32_t*>(row_ptr),
                        static_cast<const uint32_t*>(need),
                        static_cast<const int32_t*>(col_idx),
                        static_cast<const uint32_t*>(frontier),
                        static_cast<uint32_t*>(acc), n, nf, w, m, max_pos,
                        vec);
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns cudaGetLastError(). row_ptr has n + 1 entries, need
// and acc are [n, w] and frontier [nf, w], row-major; the kernel writes
// every word of acc.
extern "C" int msbfs_probe_launch(const void* row_ptr, const void* need,
                                  const void* col_idx, const void* frontier,
                                  void* acc, int n, int nf, int w,
                                  long long m, int max_pos, int sms,
                                  void* stream) {
  if (n <= 0 || w <= 0 || m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w == 1)
    launch<1>(row_ptr, need, col_idx, frontier, acc, n, nf, w, m, max_pos,
              sms, s);
  else if (w == 2)
    launch<2>(row_ptr, need, col_idx, frontier, acc, n, nf, w, m, max_pos,
              sms, s);
  else if (w <= 4)
    launch<4>(row_ptr, need, col_idx, frontier, acc, n, nf, w, m, max_pos,
              sms, s);
  else
    launch<8>(row_ptr, need, col_idx, frontier, acc, n, nf, w, m, max_pos,
              sms, s);
  return static_cast<int>(cudaGetLastError());
}
