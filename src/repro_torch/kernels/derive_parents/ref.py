"""Plain PyTorch version of the parent derivation kernel."""
from __future__ import annotations

import torch

PARENT_LANE_CHUNK = 8   # lanes per [m, chunk] buffer


def derive_parents_ref(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                       src_idx: torch.Tensor, depth: torch.Tensor,
                       base: int = 0) -> torch.Tensor:
    """parent[v, r] = min-id neighbour of v one level up in lane r, for the
    rows [base, base + n_loc) of the global ``depth`` [n, R] (n_loc =
    ``row_ptr``'s rows), -1 where none is; the caller seats the roots. Pad
    slots name the sentinel n and so never win.

    Chunked over lanes to bound the [m, chunk] candidate buffers (four
    int32 and one bool, about 5 GB at 2^25 edge slots and 8 lanes). The
    min goes through ``index_reduce_`` with the 1-D row index, so no
    [m, chunk] int64 index is built. Min-id matches the serial steps'
    deterministic scatter-min parent choice."""
    n, num_roots = depth.shape
    n_loc = row_ptr.shape[0] - 1
    src, col = src_idx, col_idx
    colc = col.clamp(max=n - 1)
    parent = torch.empty((n_loc, num_roots), dtype=torch.int32,
                         device=depth.device)
    for lo in range(0, num_roots, PARENT_LANE_CHUNK):
        d = depth[:, lo:lo + PARENT_LANE_CHUNK]
        d_col = d.index_select(0, colc)                 # [m, c]
        ok = (d_col >= 0) & (
            d_col + 1 == d[base:base + n_loc].index_select(0, src))
        del d_col
        cand = torch.where(ok, col[:, None], n).to(torch.int32)
        del ok
        best = torch.full((n_loc, d.shape[1]), n, dtype=torch.int32,
                          device=depth.device)
        best.index_reduce_(0, src, cand, "amin")
        del cand
        parent[:, lo:lo + PARENT_LANE_CHUNK] = torch.where(best < n, best,
                                                           -1)
    return parent
