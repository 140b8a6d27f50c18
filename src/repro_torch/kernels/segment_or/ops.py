"""Public wrapper for the fused row-OR kernel.

``segment_or_rows`` is what both packed steps of
``repro_torch.core.packed`` call:

  out[v] = base[v] | (mask[v] & OR over pos in [min_pos, deg_v) of
                      frontier[col_idx[row_ptr[v] + pos]] & sel)   if row v is active
  out[v] = base[v]                                                 otherwise

Top-down: ``sel = td_sel``, ``mask = ~visited``, no base, every row active.
Bottom-up fallback: ``min_pos = max_pos``, ``mask = need``, ``base =
found``, the active rows are the probe's residue. A CUDA tensor launches the
kernel (or raises); a CPU tensor takes the plain PyTorch version.

64-bit words (int64) go to both routes as their int32 view (``sel`` [W]
becomes [2W] in the same interleave) and the result is viewed back: an OR
of the halves is the OR of the words.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import word_planes
from repro_torch.kernels.segment_or.kernel import segment_or_rows_cuda
from repro_torch.kernels.segment_or.ref import segment_or_rows_ref


def segment_or_rows(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                    frontier: torch.Tensor, mask: torch.Tensor,
                    sel: torch.Tensor | None = None,
                    base: torch.Tensor | None = None,
                    row_active: torch.Tensor | None = None,
                    min_pos: int = 0) -> torch.Tensor:
    dtype = mask.dtype
    frontier, mask = word_planes(frontier), word_planes(mask)
    sel = None if sel is None else word_planes(sel)
    base = None if base is None else word_planes(base)
    if col_idx.device.type == "cuda":
        active = None if row_active is None else row_active.to(torch.int32)
        out = segment_or_rows_cuda(row_ptr, col_idx, frontier, mask, sel,
                                   base, active, min_pos)
    elif col_idx.device.type == "cpu":
        out = segment_or_rows_ref(row_ptr, col_idx, frontier, mask, sel,
                                  base, row_active, min_pos)
    else:
        raise ValueError(f"no segment_or for device {col_idx.device}")
    return out.view(dtype)
