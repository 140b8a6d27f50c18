"""Public wrapper for the residue fold of the ELL sum aggregation.

``spmm_residue`` is what ``repro_torch.kernels.ell_spmm.ops.
spmm_aggregate`` calls after the slab sum:

  y[v] += sum over pos in [k_max, deg_v) of x[col_idx[row_ptr[v] + pos]]

in place, returning ``y``. Rows of degree <= k_max keep y, so the fold
needs no read-back of whether any row is that deep. A CUDA tensor launches
the kernel (or raises); a CPU tensor takes the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.core.csr import CSRGraph
from repro_torch.kernels.spmm_residue.kernel import spmm_residue_cuda
from repro_torch.kernels.spmm_residue.ref import spmm_residue_ref


def spmm_residue(g: CSRGraph, x: torch.Tensor, y: torch.Tensor,
                 k_max: int = 16) -> torch.Tensor:
    if g.col_idx.device.type == "cuda":
        return spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y,
                                 k_max)
    if g.col_idx.device.type == "cpu":
        return spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx, x, y, k_max)
    raise ValueError(f"no spmm_residue for device {g.col_idx.device}")
