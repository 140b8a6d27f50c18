"""Public wrapper for the residue fold of the tropical relax.

``relax_fallback`` is what ``repro_torch.traversal.semiring.tropical_relax``
calls after ``semiring_relax`` on its kernel path:

  base[v, l] = min(base[v, l], min over pos in [max_pos, deg_v) of
                   vals[col_idx[row_ptr[v] + pos], l] + w[row_ptr[v] + pos])

in place, returning ``base``. Rows of degree <= max_pos keep their base, so
the fold needs no read-back of whether any row is that deep. A CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain PyTorch
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.relax_fallback.kernel import relax_fallback_cuda
from repro_torch.kernels.relax_fallback.ref import relax_fallback_ref


def relax_fallback(row_ptr: torch.Tensor, src_idx: torch.Tensor,
                   col_idx: torch.Tensor, weights: torch.Tensor,
                   vals: torch.Tensor, base: torch.Tensor,
                   max_pos: int = 8) -> torch.Tensor:
    if col_idx.device.type == "cuda":
        return relax_fallback_cuda(row_ptr, src_idx, col_idx, weights, vals,
                                   base, max_pos)
    if col_idx.device.type == "cpu":
        return relax_fallback_ref(row_ptr, src_idx, col_idx, weights, vals,
                                  base, max_pos)
    raise ValueError(f"no relax_fallback for device {col_idx.device}")
