"""Public wrapper for the residue fold of the ELL sum aggregation.

``spmm_residue`` is what ``repro_torch.kernels.ell_spmm.ops.
spmm_aggregate`` calls after the slab sum:

  y[v] += sum over pos in [k_max, deg_v) of x[col_idx[row_ptr[v] + pos]]

in place, returning ``y``. Rows of degree <= k_max keep y, so the fold
needs no read-back of whether any row is that deep; dead slots (past
``row_ptr[n]``) add nothing. A CUDA tensor launches the kernel (or
raises); a CPU tensor takes the plain PyTorch version; a meta tensor (the
dry-run) runs the custom op ``repro_torch::spmm_residue``, which returns a
fresh tensor of y's shape in place of the update, so that a counting trace
sees one op that reads the kernel's inputs (y among them) and writes y,
with the FLOPs of ``residue_flops``.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.csr import CSRGraph
from repro_torch.kernels.spmm_residue.kernel import spmm_residue_cuda
from repro_torch.kernels.spmm_residue.ref import spmm_residue_ref


@torch.library.custom_op("repro_torch::spmm_residue", mutates_args=())
def _residue_on_meta(row_ptr: torch.Tensor, src_idx: torch.Tensor,
                     col_idx: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     k_max: int) -> torch.Tensor:
    raise ValueError("repro_torch::spmm_residue runs on meta tensors only; "
                     "call spmm_residue")


@_residue_on_meta.register_fake
def _(row_ptr, src_idx, col_idx, x, y, k_max):
    return torch.empty_like(y)


@register_flop_formula(torch.ops.repro_torch.spmm_residue)
def residue_flops(row_ptr_shape, src_idx_shape, col_idx_shape, x_shape,
                  y_shape, *args, **kwargs) -> int:
    """2 * m * d: a multiply-add for every edge slot and column, dead and
    slab slots included (an upper bound on the tail's sum, whose length
    the trace cannot see)."""
    return 2 * col_idx_shape[0] * x_shape[1]


def spmm_residue(g: CSRGraph, x: torch.Tensor, y: torch.Tensor,
                 k_max: int = 16) -> torch.Tensor:
    if g.col_idx.device.type == "cuda":
        return spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y,
                                 k_max)
    if g.col_idx.device.type == "meta":
        return _residue_on_meta(g.row_ptr, g.src_idx, g.col_idx, x, y, k_max)
    if g.col_idx.device.type == "cpu":
        return spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx, x, y, k_max)
    raise ValueError(f"no spmm_residue for device {g.col_idx.device}")
