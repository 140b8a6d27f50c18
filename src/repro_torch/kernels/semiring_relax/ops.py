"""Public wrapper for the semiring_relax kernel.

``semiring_relax`` is what ``repro_torch.traversal.semiring.tropical_relax``
calls on its kernel path, with the contract of
``repro/kernels/semiring_relax/ops.py``: the min-plus accumulator over each
row's first ``max_pos`` neighbours; the caller folds in the deeper rows'
residue (``kernels/relax_fallback``). A CUDA tensor launches the kernel (or
raises); a CPU tensor takes the plain PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.semiring_relax.kernel import semiring_relax_cuda
from repro_torch.kernels.semiring_relax.ref import semiring_relax_ref


def semiring_relax(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                   weights: torch.Tensor, vals: torch.Tensor,
                   max_pos: int = 8) -> torch.Tensor:
    if col_idx.device.type == "cuda":
        return semiring_relax_cuda(row_ptr, col_idx, weights, vals, max_pos)
    if col_idx.device.type == "cpu":
        return semiring_relax_ref(row_ptr[:-1], row_ptr[1:] - row_ptr[:-1],
                                  col_idx, weights, vals, max_pos)
    raise ValueError(f"no semiring_relax for device {col_idx.device}")
