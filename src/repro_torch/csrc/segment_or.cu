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
// as the reference's gather does. OR does not depend on order, so the
// atomics below give the plain version's bits.
//
// Bound on the H100: memory bytes. An active row reads its slice of col_idx
// (coalesced) and gathers W frontier words per edge; every row reads its row
// bounds, mask and base and writes W words. Top-down reads all m neighbour
// ids; the bottom-up fallback only the residue rows' tails. In practice the
// gathers set the time: 33.5 M random 8-byte rows of an 8 MB frontier that
// L2 holds, a 32-byte sector each, at scale 20 and W = 2.
//
// Design. R-MAT degrees are very skewed: about a million rows of a few
// slots and a few rows of up to 1.4e5. So the work of a warp is not a row.
// A warp takes 32 consecutive rows; lane i reads row i's bounds and flag,
// coalesced (an inactive row reads nothing more), and sorts it by its
// slot count c:
// * c < kShort: the short rows' slots become one list (a __shfl_up_sync
//   prefix over c), read 4 x 32 slots a round: each thread finds its
//   slot's row by a binary search over the prefix (__shfl_sync), loads the
//   slot's id, then the 4 rows' gathers are in flight together. Each
//   nonzero gathered word goes to a 32 x W shared-memory tile by a shared
//   atomicOr (a round's slots of one row share an address; a sparse
//   frontier gathers mostly zeros, which skip the atomic).
// * kShort <= c <= seg: the warp walks the row, 4 x 32 slots a round, ORs
//   in registers, reduces with __reduce_or_sync and one thread stores the
//   tile's row.
// * c > seg: the row goes to a segment list (one atomicAdd a warp) and its
//   tile row stays 0. A second launch, sized on the host and reading the
//   list's length on the device (no host sync), gives each segment of seg
//   slots to a warp, which ORs it and atomicOr's mask & partial into out.
// The 32 rows' out words are written as one coalesced block: base | (mask &
// tile) (mask is read only where the tile is nonzero), so a long row holds
// base when its segments OR into it. A frontier row of W = 2, 4 or 8 words
// is gathered by one 8- or 16-byte load where the frontier is aligned for
// it (the 32-byte sector is the same; the load instructions halve). Both
// grids are capped at the blocks that can be resident at once
// (resident_blocks), so each grid-stride loop runs in one wave. Rows of
// W > 8 words are done 8 words at a time, a pair of launches each; the
// first pair lists the segments, the later ones reuse the list.
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRound = 4;   // 32-slot reads a warp issues before gathering
constexpr int kShort = 32;  // rows of fewer slots go to the warp's list

// A slice of one long row: slots [begin, min(begin + seg, row end)).
struct Segment {
  int v;
  int begin;
};

__device__ __forceinline__ int clip_id(int u, int hi) {
  return u < 0 ? 0 : (u >= hi ? hi - 1 : u);
}

// Row u of the frontier (rows `stride` words apart), masked by s; nothing
// for u < 0. One vector load when vec (w == stride == CW, the frontier
// aligned to 4 * CW bytes, CW > 1).
template <int CW>
__device__ __forceinline__ void gather_row(
    const uint32_t* __restrict__ frontier, int u, int stride, bool vec,
    const uint32_t (&s)[CW], uint32_t (&a)[CW]) {
  const uint32_t* p = frontier + static_cast<int64_t>(u) * stride;
  if (u < 0) {
#pragma unroll
    for (int k = 0; k < CW; ++k) a[k] = 0u;
  } else if (CW == 2 && vec) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    a[0] = x.x & s[0];
    a[1 % CW] = x.y & s[1 % CW];
  } else if (CW >= 4 && vec) {
#pragma unroll
    for (int k = 0; k < CW; k += 4) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + k));
      a[k % CW] = x.x & s[k % CW];
      a[(k + 1) % CW] = x.y & s[(k + 1) % CW];
      a[(k + 2) % CW] = x.z & s[(k + 2) % CW];
      a[(k + 3) % CW] = x.w & s[(k + 3) % CW];
    }
  } else {
#pragma unroll
    for (int k = 0; k < CW; ++k)
      a[k] = s[k] != 0u ? __ldg(p + k) & s[k] : 0u;
  }
}

template <int CW>
__device__ __forceinline__ void lane_selection(const uint32_t* __restrict__ sel,
                                               int w, uint32_t (&s)[CW]) {
#pragma unroll
  for (int k = 0; k < CW; ++k)
    s[k] = k < w ? (sel == nullptr ? ~0u : sel[k]) : 0u;
}

template <int CW>
__global__ void __launch_bounds__(kThreads)
    segment_or_rows_kernel(const int32_t* __restrict__ row_ptr,
                           const int32_t* __restrict__ col_idx,
                           const uint32_t* __restrict__ frontier,
                           const uint32_t* __restrict__ mask,
                           const uint32_t* __restrict__ sel,
                           const uint32_t* __restrict__ base,
                           const int32_t* __restrict__ row_active,
                           uint32_t* __restrict__ out, int n, int nf, int w,
                           int stride, int min_pos, int seg, bool vec,
                           Segment* __restrict__ segs,
                           int* __restrict__ num_segs) {
  __shared__ uint32_t tiles[kWarps][32 * CW];
  uint32_t* tile = tiles[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  uint32_t s[CW];
  lane_selection<CW>(sel, w, s);
  for (int64_t v0 =
           ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >>
            5) * 32;
       v0 < n; v0 += nwarps * 32) {
    const int nv = n - v0 < 32 ? static_cast<int>(n - v0) : 32;
    const int64_t v = v0 + lane;
    int lo = 0, cnt = 0;
    if (lane < nv && (row_active == nullptr || row_active[v] != 0)) {
      const int64_t start = static_cast<int64_t>(row_ptr[v]) + min_pos;
      const int64_t end = row_ptr[v + 1];
      if (start < end) {
        lo = static_cast<int>(start);
        cnt = static_cast<int>(end - start);
      }
    }
    // long rows: their segments onto the list
    const int ns = cnt > seg ? (cnt + seg - 1) / seg : 0;
    int seg_incl = ns;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, seg_incl, o);
      if (lane >= o) seg_incl += x;
    }
    const int seg_total = __shfl_sync(kFull, seg_incl, 31);
    if (seg_total != 0 && segs != nullptr) {
      int first = 0;
      if (lane == 31) first = atomicAdd(num_segs, seg_total);
      first = __shfl_sync(kFull, first, 31) + seg_incl - ns;
      for (int k = 0; k < ns; ++k)
        segs[first + k] = Segment{static_cast<int>(v), lo + k * seg};
    }
    // short rows: one list of slots
    const int c = cnt < kShort && cnt <= seg ? cnt : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += x;
    }
    const int excl = incl - c;
    const int total = __shfl_sync(kFull, incl, 31);
    for (int i = lane; i < 32 * CW; i += 32) tile[i] = 0u;
    __syncwarp();
    for (int s0 = 0; s0 < total; s0 += 32 * kRound) {
      int row[kRound], u[kRound];
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int slot = s0 + q * 32 + lane;
        // the slot's row: the last j with excl[j] <= slot
        int j = 0;
#pragma unroll
        for (int step = 16; step > 0; step >>= 1) {
          const int e = __shfl_sync(kFull, excl, j + step);
          if (e <= slot) j += step;
        }
        const int ex = __shfl_sync(kFull, excl, j);
        const int st = __shfl_sync(kFull, lo, j);
        row[q] = j;
        u[q] = slot < total ? clip_id(__ldg(col_idx + st + (slot - ex)), nf)
                            : -1;
      }
      uint32_t a[kRound][CW];
#pragma unroll
      for (int q = 0; q < kRound; ++q)
        gather_row<CW>(frontier, u[q], stride, vec, s, a[q]);
#pragma unroll
      for (int q = 0; q < kRound; ++q)
#pragma unroll
        for (int k = 0; k < CW; ++k)
          if (a[q][k] != 0u) atomicOr(tile + row[q] * w + k, a[q][k]);
    }
    // medium rows: the warp walks each
    for (unsigned med = __ballot_sync(kFull, cnt >= kShort && cnt <= seg);
         med != 0u; med &= med - 1u) {
      const int j = __ffs(med) - 1;
      const int rlo = __shfl_sync(kFull, lo, j);
      const int rend = rlo + __shfl_sync(kFull, cnt, j);
      uint32_t acc[CW];
#pragma unroll
      for (int k = 0; k < CW; ++k) acc[k] = 0u;
      for (int e0 = rlo; e0 < rend; e0 += 32 * kRound) {
        int ids[kRound];
#pragma unroll
        for (int q = 0; q < kRound; ++q) {
          const int e = e0 + q * 32 + lane;
          ids[q] = e < rend ? clip_id(__ldg(col_idx + e), nf) : -1;
        }
#pragma unroll
        for (int q = 0; q < kRound; ++q) {
          uint32_t g[CW];
          gather_row<CW>(frontier, ids[q], stride, vec, s, g);
#pragma unroll
          for (int k = 0; k < CW; ++k) acc[k] |= g[k];
        }
      }
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        const uint32_t r = __reduce_or_sync(kFull, acc[k]);
        if (lane == 0 && k < w) tile[j * w + k] = r;
      }
    }
    __syncwarp();
    for (int i = lane; i < nv * w; i += 32) {
      const int64_t o =
          stride == w ? v0 * w + i : (v0 + i / w) * stride + i % w;
      const uint32_t t = tile[i];
      const uint32_t b = base == nullptr ? 0u : base[o];
      out[o] = b | (t != 0u ? mask[o] & t : 0u);
    }
    __syncwarp();
  }
}

template <int CW>
__global__ void __launch_bounds__(kThreads)
    segment_or_segments_kernel(const int32_t* __restrict__ row_ptr,
                               const int32_t* __restrict__ col_idx,
                               const uint32_t* __restrict__ frontier,
                               const uint32_t* __restrict__ mask,
                               const uint32_t* __restrict__ sel,
                               uint32_t* __restrict__ out, int nf, int w,
                               int stride, int seg, bool vec,
                               const Segment* __restrict__ segs,
                               const int* __restrict__ num_segs) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int total = *num_segs;
  uint32_t s[CW];
  lane_selection<CW>(sel, w, s);
  for (int64_t k =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       k < total; k += nwarps) {
    const Segment sg = segs[k];
    const int row_end = row_ptr[sg.v + 1];
    const int end = row_end - sg.begin < seg ? row_end : sg.begin + seg;
    uint32_t acc[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[j] = 0u;
    for (int e0 = sg.begin; e0 < end; e0 += 32 * kRound) {
      int ids[kRound];
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int e = e0 + q * 32 + lane;
        ids[q] = e < end ? clip_id(__ldg(col_idx + e), nf) : -1;
      }
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        uint32_t g[CW];
        gather_row<CW>(frontier, ids[q], stride, vec, s, g);
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[j] |= g[j];
      }
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const uint32_t r = __reduce_or_sync(kFull, acc[j]);
      if (lane == j && j < w && r != 0u) {
        const int64_t o = static_cast<int64_t>(sg.v) * stride + j;
        atomicOr(out + o, mask[o] & r);
      }
    }
  }
}

// One chunk of w <= CW words of each row, rows `stride` words apart; the
// pointers already point at the chunk's first word. segs == nullptr makes
// the row kernel leave the list as it is.
template <int CW>
void launch(const int32_t* row_ptr, const int32_t* col_idx,
            const uint32_t* frontier, const uint32_t* mask,
            const uint32_t* sel, const uint32_t* base,
            const int32_t* row_active, uint32_t* out, int n, int nf, int w,
            int stride, int min_pos, int seg, long long max_segs,
            Segment* list, const Segment* segs, int* num_segs, int sms,
            cudaStream_t stream) {
  const bool vec = CW > 1 && w == CW && stride == CW &&
                   reinterpret_cast<uintptr_t>(frontier) % (4 * CW > 16 ? 16 : 4 * CW) == 0;
  auto rows = segment_or_rows_kernel<CW>;
  rows<<<repro_torch::resident_blocks(
             rows, (static_cast<long long>(n) + 31) / 32 * 32, kThreads, sms),
         kThreads, 0, stream>>>(row_ptr, col_idx, frontier, mask, sel, base,
                                row_active, out, n, nf, w, stride, min_pos,
                                seg, vec, list, num_segs);
  auto tails = segment_or_segments_kernel<CW>;
  tails<<<repro_torch::resident_blocks(tails, max_segs * 32, kThreads, sms),
          kThreads, 0, stream>>>(row_ptr, col_idx, frontier, mask, sel, out,
                                 nf, w, stride, seg, vec, segs, num_segs);
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns the first CUDA error. mask, base and out are [n, w]
// and frontier [nf, w], row-major, any w >= 1; sel has w words. scratch
// holds the segment list: an int count, an int of padding, then max_segs
// (row, begin) pairs, max_segs >= 2 * m / seg + 1 (a row of c > seg slots
// makes ceil(c / seg) < 2 c / seg segments).
extern "C" int segment_or_launch(const void* row_ptr, const void* col_idx,
                                 const void* frontier, const void* mask,
                                 const void* sel, const void* base,
                                 const void* row_active, void* out, int n,
                                 int nf, int w, int min_pos, int seg,
                                 long long max_segs, void* scratch, int sms,
                                 void* stream) {
  if (n <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* num_segs = static_cast<int*>(scratch);
  cudaError_t err = cudaMemsetAsync(num_segs, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  Segment* segs = reinterpret_cast<Segment*>(num_segs + 2);
  for (int w0 = 0; w0 < w; w0 += 8) {
    const int cw = w - w0 < 8 ? w - w0 : 8;
    auto words = [w0](const void* p) {
      return p == nullptr ? nullptr : static_cast<const uint32_t*>(p) + w0;
    };
    auto go = [&](auto chunk) {
      launch<decltype(chunk)::value>(
          static_cast<const int32_t*>(row_ptr),
          static_cast<const int32_t*>(col_idx), words(frontier), words(mask),
          words(sel), words(base), static_cast<const int32_t*>(row_active),
          static_cast<uint32_t*>(out) + w0, n, nf, cw, w, min_pos, seg,
          max_segs, w0 == 0 ? segs : nullptr, segs, num_segs, sms, s);
    };
    if (cw == 1)
      go(std::integral_constant<int, 1>());
    else if (cw == 2)
      go(std::integral_constant<int, 2>());
    else if (cw <= 4)
      go(std::integral_constant<int, 4>());
    else
      go(std::integral_constant<int, 8>());
  }
  return static_cast<int>(cudaGetLastError());
}
