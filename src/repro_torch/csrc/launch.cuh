// Launch geometry shared by the kernels in this directory.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// Blocks for a grid-stride loop over `count` items with `threads` threads
// per block: enough to cover the items, and at most 8 blocks per SM (2048
// threads of 256, an H100 SM's maximum), so that the loop, not the block
// scheduler, walks a large input. `sms` is the SM count of the device the
// launch goes to; the caller reads it. The cap holds only for kernels of
// at most 32 registers a thread; bottom_up_probe.cu and msbfs_probe.cu
// still use it (msbfs_probe at W >= 4 is above 32), every other kernel
// uses resident_blocks.
inline int grid_blocks(long long count, int threads, int sms) {
  const long long needed = (count + threads - 1) / threads;
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  return static_cast<int>(needed < cap ? needed : cap);
}

// As grid_blocks, but capped at the blocks of `kernel` that can be resident
// at once (its registers decide), so that a grid-stride loop runs in one
// wave instead of leaving part of its blocks to a second, partial one.
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
