// Launch geometry shared by the kernels in this directory.
#pragma once

namespace repro_torch {

// Blocks for a grid-stride loop over `count` items with `threads` threads
// per block: enough to cover the items, and at most 8 blocks per SM (2048
// threads of 256, an H100 SM's maximum), so that the loop, not the block
// scheduler, walks a large input. `sms` is the SM count of the device the
// launch goes to; the caller reads it.
inline int grid_blocks(long long count, int threads, int sms) {
  const long long needed = (count + threads - 1) / threads;
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  return static_cast<int>(needed < cap ? needed : cap);
}

}  // namespace repro_torch
