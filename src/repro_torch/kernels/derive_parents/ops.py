"""Public wrapper for the parent derivation kernel.

``derive_parents`` is what ``repro_torch.core.msbfs._derive_parents``
calls, for every caller (the single batch, the pipelined engine's result,
a 1-D rank's block, a 2-D grid block):

  parent[v, l] = min { u = col_idx[e] : e in row v's slots, u < n,
                       depth[u, l] >= 0, depth[u, l] + 1 == depth[base + v, l] }

and -1 where no neighbour qualifies, for the rows [base, base + n_loc) of
the global depth int32[n, R]. A CUDA tensor launches the kernel (two
launches, spans ``parents.narrow`` and ``parents.scan``) or raises; a CPU
tensor takes the plain PyTorch version (span ``parents.scan``). The kernel
reads each row's slots from ``row_ptr``, the plain version each slot's row
from ``src_idx``; the two name the same rows, and a pad slot past the last
row holds the sentinel column n, which never wins.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.derive_parents.kernel import (narrow_depths_cuda,
                                                       scan_parents_cuda)
from repro_torch.kernels.derive_parents.ref import derive_parents_ref
from repro_torch.obs import spans


def derive_parents(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                   src_idx: torch.Tensor, depth: torch.Tensor,
                   base: int = 0) -> torch.Tensor:
    if depth.device.type == "cuda":
        with spans.span("parents.narrow"):
            narrow = narrow_depths_cuda(depth)
        with spans.span("parents.scan"):
            return scan_parents_cuda(row_ptr, col_idx, narrow,
                                     depth.shape[1], base)
    if depth.device.type == "cpu":
        with spans.span("parents.scan"):
            return derive_parents_ref(row_ptr, col_idx, src_idx, depth, base)
    raise ValueError(f"no derive_parents for device {depth.device}")
