"""Plain PyTorch versions of the top-down scan.

``topdown_scan_ref`` is what the TPU kernel computes (one parent candidate
per edge slot); ``topdown_best_ref`` adds the scatter-min by destination and
is the plain version of the fused CUDA kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmap


def topdown_scan_ref(src_idx, col_idx, frontier_words, visited_words,
                     n: int) -> torch.Tensor:
    """cand int32[m]: src_idx[e] if its source is in the frontier and its
    destination is unvisited, else n."""
    active = bitmap.test(frontier_words, src_idx) & ~bitmap.test(
        visited_words, col_idx)
    return torch.where(active, src_idx, n).to(torch.int32)


def topdown_best_ref(src_idx, col_idx, frontier_words, visited_words,
                     n: int) -> torch.Tensor:
    """best int32[n]: min candidate per destination, n where there is none."""
    cand = topdown_scan_ref(src_idx, col_idx, frontier_words, visited_words, n)
    best = torch.full((n,), n, dtype=torch.int32, device=src_idx.device)
    return best.scatter_reduce_(0, col_idx.to(torch.int64), cand, "amin")
