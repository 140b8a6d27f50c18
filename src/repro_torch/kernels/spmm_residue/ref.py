"""Plain PyTorch version of the spmm_residue kernel."""
from __future__ import annotations

import torch

CHUNK_SLOTS = 1 << 22


def spmm_residue_ref(row_ptr, src_idx, col_idx, x, y,
                     k_max: int = 16) -> torch.Tensor:
    """The kernel's function in tensor ops, as the reference's residue
    (``repro/kernels/ell_spmm/ops.py:28-31``): edge slot e of row
    ``src_idx[e]`` at position ``e - row_ptr[src_idx[e]] >= k_max`` adds
    ``x[clip(col_idx[e])]`` to its row's tail sum, and ``y += tail`` in
    place; returns ``y``. A dead slot (row n, past ``row_ptr[n]``, as
    ``core.csr.from_edge_tensors`` leaves masked edges) adds nothing. In
    x's dtype (float64 too, for gradcheck); the slots go in chunks of
    ``CHUNK_SLOTS``, so the gathered rows stay small."""
    m = col_idx.shape[0]
    n_src = x.shape[0]
    n = row_ptr.shape[0] - 1
    if m == 0 or n_src == 0 or y.shape[0] == 0:
        return y
    tail = torch.zeros_like(y)
    for lo in range(0, m, CHUNK_SLOTS):
        hi = min(m, lo + CHUNK_SLOTS)
        row = src_idx[lo:hi].long()
        pos = torch.arange(lo, hi, device=col_idx.device) - row_ptr[row]
        deep = (pos >= k_max) & (row < n)
        cols = col_idx[lo:hi][deep].long().clamp(0, n_src - 1)
        tail.index_add_(0, row[deep], x[cols])
    return y.add_(tail)
