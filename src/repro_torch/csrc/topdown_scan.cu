// Top-down edge scan fused with the scatter-min by destination, for sm_90a.
//
// Replaces the TPU kernel
//   src/repro/kernels/topdown_scan/kernel.py::topdown_scan_pallas
//   (body _scan_kernel),
// together with the scatter-min that follows it outside the kernel
// (src/repro/kernels/topdown_scan/ops.py::topdown_step_pallas). For each
// frontier vertex u < n and each slot e of its row with v = col_idx[e] in
// [0, n) not visited, best[v] = min(best[v], u); best is n elsewhere. Bits
// of the frontier words for ids >= n are ignored. Min does not depend on
// the order of the updates, so the result is deterministic and equal to the
// reference's scatter-min.
//
// Bound on the H100: memory bytes. The work needs both bitmaps (n / 32
// words each, 128 KiB at 2^20 vertices, held in L2), the frontier rows'
// bounds, their col_idx slots (4 bytes each) and one write of best (4 n
// bytes). The hybrid controller runs top-down only while the frontier's
// edges are few (e_f < e_u / alpha), so a scan of all m slots (the TPU
// kernel's src_idx pass, 134 MB at scale 20) would pay for many times the
// bytes the layer uses.
//
// Design: two launches, no host sync.
// * Launch 1 fills best with n and lists the frontier. A warp takes four
//   frontier words (128 vertices); lane i tests bit i of each, and the
//   vertices with slots read their row bounds. A warp prefix over their
//   slot counts (__shfl_up_sync) and one 64-bit atomicAdd, which packs the
//   entry count (high 28 bits) with the slot count (low 36), reserve room
//   for the warp's entries (vertex, row start, first slot in the list), so
//   list offsets rise with entry order. A word of zeros costs its load.
// * Launch 2 grid-strides over the list's slots, its total read on the
//   device. A warp takes kChunk consecutive slots, finds the entry of the
//   first by a 32-way search over the offsets (32 probes a step, a ballot
//   picks the interval), and reads the chunk 32 slots a trip: 32 entries
//   from there cover the trip (an entry has >= 1 slot), each thread finds
//   its slot's entry by a binary search over them (__shfl_sync), loads the
//   slot's neighbour, tests the visited bit and does atomicMin(best + v,
//   u). A hub's row is cut over many warps like any other slots.
// Both grids are capped at the blocks that can be resident at once
// (resident_blocks). An empty frontier costs the fill and two short
// launches.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWordsPerWarp = 4;  // frontier words a warp lists at a time
constexpr int kChunk = 64;        // list slots a warp scans at a time
constexpr int kEntryShift = 36;   // the counter: entries << 36 | slots
constexpr unsigned long long kSlotMask = (1ull << kEntryShift) - 1;

__device__ __forceinline__ bool bit_set(const uint32_t* __restrict__ words,
                                        int num_words, uint32_t id) {
  const uint32_t word = id >> 5;
  return word < static_cast<uint32_t>(num_words) &&
         ((__ldg(words + word) >> (id & 31u)) & 1u);
}

__global__ void __launch_bounds__(kThreads)
    frontier_list_kernel(const int32_t* __restrict__ row_ptr,
                         const uint32_t* __restrict__ frontier_words,
                         int frontier_num_words, int32_t* __restrict__ best,
                         int n, int* __restrict__ ent_v,
                         int* __restrict__ ent_start,
                         int* __restrict__ ent_off,
                         unsigned long long* __restrict__ counter) {
  constexpr int R = kWordsPerWarp;
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t words = (static_cast<int64_t>(n) + 31) >> 5;
  const int64_t listed =
      words < frontier_num_words ? words : frontier_num_words;
  for (int64_t g =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       g * R < words; g += nwarps) {
    uint32_t word[R];
    uint32_t any = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t wi = g * R + r;
      const int64_t v = wi * 32 + lane;
      if (v < n) best[v] = n;
      word[r] = wi < listed ? __ldg(frontier_words + wi) : 0u;
      any |= word[r];
    }
    if (any == 0u) continue;  // the same words in every lane: uniform
    int lo[R], deg[R], incl[R];
    unsigned keep[R];
    int entries = 0, slots = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t v = (g * R + r) * 32 + lane;
      lo[r] = 0;
      deg[r] = 0;
      if (v < n && ((word[r] >> lane) & 1u)) {
        lo[r] = row_ptr[v];
        deg[r] = row_ptr[v + 1] - lo[r];
      }
      keep[r] = __ballot_sync(kFull, deg[r] > 0);
      incl[r] = deg[r];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int x = __shfl_up_sync(kFull, incl[r], o);
        if (lane >= o) incl[r] += x;
      }
      entries += __popc(keep[r]);
      slots += __shfl_sync(kFull, incl[r], 31);
    }
    if (entries == 0) continue;
    unsigned long long first = 0;
    if (lane == 0)
      first = atomicAdd(counter,
                        (static_cast<unsigned long long>(entries)
                         << kEntryShift) | static_cast<unsigned>(slots));
    first = __shfl_sync(kFull, first, 0);
    int64_t k0 = static_cast<int64_t>(first >> kEntryShift);
    int s0 = static_cast<int>(first & kSlotMask);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (deg[r] > 0) {
        const int64_t k = k0 + __popc(keep[r] & ((1u << lane) - 1u));
        ent_v[k] = static_cast<int>((g * R + r) * 32 + lane);
        ent_start[k] = lo[r];
        ent_off[k] = s0 + incl[r] - deg[r];
      }
      k0 += __popc(keep[r]);
      s0 += __shfl_sync(kFull, incl[r], 31);
    }
  }
}

// The last k in [0, count) with off[k] <= s (off[0] == 0 <= s): 32 probes
// a step, so a list of 2^20 entries takes four steps.
__device__ __forceinline__ int find_entry(const int* __restrict__ off,
                                          int count, int s, int lane) {
  int lo = 0, hi = count;
  while (hi - lo > 32) {
    const int stride = (hi - lo + 31) / 32;
    const int64_t idx = lo + static_cast<int64_t>(lane) * stride;
    const int val = idx < hi ? off[idx] : INT_MAX;
    const int below = __popc(__ballot_sync(kFull, val <= s));
    const int64_t top = lo + static_cast<int64_t>(below) * stride;
    hi = top < hi ? static_cast<int>(top) : hi;
    lo += (below - 1) * stride;
  }
  const int idx = lo + lane;
  const int val = idx < hi ? off[idx] : INT_MAX;
  return lo + __popc(__ballot_sync(kFull, val <= s)) - 1;
}

__global__ void __launch_bounds__(kThreads)
    frontier_scan_kernel(const int32_t* __restrict__ col_idx,
                         const uint32_t* __restrict__ visited_words,
                         int visited_num_words, int32_t* __restrict__ best,
                         int n, const int* __restrict__ ent_v,
                         const int* __restrict__ ent_start,
                         const int* __restrict__ ent_off,
                         const unsigned long long* __restrict__ counter) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const unsigned long long total = *counter;
  const int entries = static_cast<int>(total >> kEntryShift);
  const int slots = static_cast<int>(total & kSlotMask);
  for (int64_t c0 =
           ((static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >>
            5) * kChunk;
       c0 < slots; c0 += nwarps * kChunk) {
    const int c1 = c0 + kChunk < slots ? static_cast<int>(c0 + kChunk) : slots;
    int k0 = find_entry(ent_off, entries, static_cast<int>(c0), lane);
    for (int s0 = static_cast<int>(c0); s0 < c1; s0 += 32) {
      // entries k0 .. k0 + 31 cover slots s0 .. s0 + 31
      const int kk = k0 + lane;
      const int off_l = kk < entries ? ent_off[kk] : INT_MAX;
      const int v_l = kk < entries ? ent_v[kk] : 0;
      const int start_l = kk < entries ? ent_start[kk] : 0;
      const int s = s0 + lane;
      int j = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int e = __shfl_sync(kFull, off_l, j + step);
        if (e <= s) j += step;
      }
      const int off = __shfl_sync(kFull, off_l, j);
      const int u = __shfl_sync(kFull, v_l, j);
      const int start = __shfl_sync(kFull, start_l, j);
      // the entry of the next trip's first slot: in this window, or the
      // one just past it when all 32 begin by then
      const int in_window = __popc(__ballot_sync(kFull, off_l <= s0 + 32));
      int next = k0 + in_window - 1;
      if (in_window == 32 && k0 + 32 < entries && ent_off[k0 + 32] <= s0 + 32)
        next = k0 + 32;
      k0 = next;
      if (s < c1) {
        const uint32_t v =
            static_cast<uint32_t>(__ldg(col_idx + start + (s - off)));
        if (v < static_cast<uint32_t>(n) &&
            !bit_set(visited_words, visited_num_words, v))
          atomicMin(best + v, u);
      }
    }
  }
}

}  // namespace

// Launches on `stream` of the current device, which has `sms` SMs; does not
// synchronise; returns the first CUDA error. row_ptr has n + 1 entries;
// scratch holds the frontier list: an 8-byte counter, then three int arrays
// of n entries (vertex, row start, list offset); n < 2^28 and m < 2^31.
extern "C" int topdown_scan_launch(const void* row_ptr, const void* col_idx,
                                   const void* frontier_words,
                                   const void* visited_words, void* best,
                                   void* scratch, long long m, int n,
                                   int frontier_num_words,
                                   int visited_num_words, int sms,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* counter = static_cast<unsigned long long*>(scratch);
  int* ent_v = static_cast<int*>(scratch) + 2;
  int* ent_start = ent_v + n;
  int* ent_off = ent_start + n;
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(*counter), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long groups =
      (static_cast<long long>(n) + 32 * kWordsPerWarp - 1) /
      (32 * kWordsPerWarp);
  frontier_list_kernel<<<repro_torch::resident_blocks(frontier_list_kernel,
                                                      groups * 32, kThreads,
                                                      sms),
                         kThreads, 0, s>>>(
      static_cast<const int32_t*>(row_ptr),
      static_cast<const uint32_t*>(frontier_words), frontier_num_words,
      static_cast<int32_t*>(best), n, ent_v, ent_start, ent_off, counter);
  const long long chunks = m > kChunk ? (m + kChunk - 1) / kChunk : 1;
  frontier_scan_kernel<<<repro_torch::resident_blocks(frontier_scan_kernel,
                                                      chunks * 32, kThreads,
                                                      sms),
                         kThreads, 0, s>>>(
      static_cast<const int32_t*>(col_idx),
      static_cast<const uint32_t*>(visited_words), visited_num_words,
      static_cast<int32_t*>(best), n, ent_v, ent_start, ent_off, counter);
  return static_cast<int>(cudaGetLastError());
}
