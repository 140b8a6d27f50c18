"""Public wrapper for the bottom_up_probe kernel.

``bottom_up_probe`` is what ``repro_torch.core.bottomup`` calls; it matches
``repro/kernels/bottom_up_probe/ops.py``: (found bool[n], parent int32[n]).
A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
PyTorch version; a meta tensor (the dry-run) runs the custom op
``repro_torch::bottom_up_probe``, whose fake implementation gives the
kernel's outputs' shapes and dtypes, so that a counting trace sees one op
that reads the kernel's inputs and writes its outputs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bottom_up_probe.kernel import bottom_up_probe_cuda
from repro_torch.kernels.bottom_up_probe.ref import bottom_up_probe_ref


@torch.library.custom_op("repro_torch::bottom_up_probe", mutates_args=())
def _probe_on_meta(row_ptr: torch.Tensor, unvisited: torch.Tensor,
                   parent: torch.Tensor, col_idx: torch.Tensor,
                   frontier_words: torch.Tensor,
                   max_pos: int) -> tuple[torch.Tensor, torch.Tensor]:
    raise ValueError("repro_torch::bottom_up_probe runs on meta tensors "
                     "only; call bottom_up_probe")


@_probe_on_meta.register_fake
def _(row_ptr, unvisited, parent, col_idx, frontier_words, max_pos):
    return torch.empty_like(parent), torch.empty_like(parent)


def bottom_up_probe(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                    frontier_words: torch.Tensor, unvisited: torch.Tensor,
                    parent: torch.Tensor, max_pos: int = 8):
    """The kernel reads ``row_ptr`` and the bool ``unvisited`` as they are;
    the plain version takes the reference's starts, degrees and int32
    flags, built from them."""
    if col_idx.device.type == "cuda":
        found, par = bottom_up_probe_cuda(row_ptr, unvisited, parent, col_idx,
                                          frontier_words, max_pos)
    elif col_idx.device.type == "meta":
        found, par = _probe_on_meta(row_ptr, unvisited, parent, col_idx,
                                    frontier_words, max_pos)
    elif col_idx.device.type == "cpu":
        found, par = bottom_up_probe_ref(row_ptr[:-1], row_ptr.diff(),
                                         unvisited.to(torch.int32), parent,
                                         col_idx, frontier_words, max_pos)
    else:
        raise ValueError(f"no bottom_up_probe for device {col_idx.device}")
    return found != 0, par
