// Launch geometry shared by the kernels in this directory.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Blocks for a grid-stride loop over `count` items with `threads` threads
// per block: enough to cover the items, and at most the blocks of `kernel`
// that can be resident at once (its registers and shared memory decide), so
// that the loop runs in one wave instead of leaving part of its blocks to a
// second, partial one. `sms` is the SM count of the device the launch goes
// to; the caller reads it.
template <class Kernel>
inline int resident_blocks(Kernel kernel, long long count, int threads,
                           int sms) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long needed = (count + threads - 1) / threads;
  const long long cap = static_cast<long long>(per_sm) * (sms > 0 ? sms : 1);
  return static_cast<int>(needed < cap ? needed : cap);
}

}  // namespace repro_torch
