"""Public wrapper for the fused top-down scan.

``topdown_scan`` is what ``repro_torch.core.topdown.topdown_step`` calls. A
CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.topdown_scan.kernel import topdown_scan_cuda
from repro_torch.kernels.topdown_scan.ref import topdown_best_ref


def topdown_scan(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                 frontier_words: torch.Tensor, visited_words: torch.Tensor,
                 n: int) -> torch.Tensor:
    """best int32[n]: min frontier source of each unvisited destination.
    The kernel walks the frontier's rows by ``row_ptr``; the plain version
    scans every slot, each with its row (``row_ptr`` expanded), as the
    reference does."""
    if col_idx.device.type == "cuda":
        return topdown_scan_cuda(row_ptr, col_idx, frontier_words,
                                 visited_words, n)
    if col_idx.device.type == "cpu":
        src_idx = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32), row_ptr.diff(),
            output_size=col_idx.numel())
        return topdown_best_ref(src_idx, col_idx, frontier_words,
                                visited_words, n)
    raise ValueError(f"no topdown_scan for device {col_idx.device}")
