"""Plain PyTorch version of the ell_spmm kernel."""
from __future__ import annotations

import torch

CHUNK_ROWS = 1 << 18


def ell_spmm_ref(neigh, valid, x) -> torch.Tensor:
    """The kernel's function in tensor ops, as ``repro.kernels.ell_spmm.
    ref``: ``Y[i] = sum_k valid[i,k] * X[clip(neigh[i,k])]``, folded slot by
    slot in x's dtype (float64 too, for gradcheck). Rows go in chunks of
    ``CHUNK_ROWS``, so the gathered [rows, d] block stays small: all of
    ``x[neigh]`` at ogb_products would be [2.45 M, 16, 100]."""
    n, k_max = neigh.shape
    n_src, d = x.shape
    y = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    if n_src == 0:
        return y
    idx = neigh.clamp(0, n_src - 1)
    for lo in range(0, n, CHUNK_ROWS):
        hi = min(n, lo + CHUNK_ROWS)
        acc = y[lo:hi]
        for k in range(k_max):
            rows = x[idx[lo:hi, k]]
            acc += torch.where(valid[lo:hi, k, None], rows, 0.0)
    return y
