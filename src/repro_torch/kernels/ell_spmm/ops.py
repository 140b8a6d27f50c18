"""Public wrappers: the slab sum, and the full sum aggregation.

``spmm_aggregate(g, x, k_max)`` computes ``Y[v] = sum_{u in adj(v)} X[u]``
exactly, with the contract of ``repro/kernels/ell_spmm/ops.py``: the ELL
slab covers positions < k_max (``ell_spmm``), the residue (positions >=
k_max, heavy hubs) is added after it (``spmm_residue``), the same
bounded-probe + fallback split as the BFS bottom-up. A CUDA tensor
launches the kernels (or raises); a CPU tensor takes their plain versions;
a meta tensor (the dry-run) runs the custom op ``repro_torch::ell_spmm``,
whose fake implementation gives the kernel's [n, d] output, so that a
counting trace sees one op that reads the kernel's inputs and writes its
output, with the FLOPs of ``slab_flops``. ``ell`` passes a slab already
built by ``core.csr.ell_pad(g, k_max)``.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core.csr import CSRGraph, ell_pad
from repro_torch.kernels.ell_spmm.kernel import ell_spmm_cuda
from repro_torch.kernels.ell_spmm.ref import ell_spmm_ref
from repro_torch.kernels.spmm_residue.ops import spmm_residue
from repro_torch.kernels.spmm_residue.ref import spmm_residue_ref


@torch.library.custom_op("repro_torch::ell_spmm", mutates_args=())
def _slab_on_meta(neigh: torch.Tensor, valid: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    raise ValueError("repro_torch::ell_spmm runs on meta tensors only; "
                     "call ell_spmm")


@_slab_on_meta.register_fake
def _(neigh, valid, x):
    return x.new_empty((neigh.shape[0], x.shape[1]))


@register_flop_formula(torch.ops.repro_torch.ell_spmm)
def slab_flops(neigh_shape, valid_shape, x_shape, *args, **kwargs) -> int:
    """2 * n * k_max * d: a multiply-add for every slab slot and column,
    valid or not (an upper bound on the slab's own sum)."""
    n, k_max = neigh_shape
    return 2 * n * k_max * x_shape[1]


def ell_spmm(neigh: torch.Tensor, valid: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    if neigh.device.type == "cuda":
        return ell_spmm_cuda(neigh, valid, x)
    if neigh.device.type == "meta":
        return _slab_on_meta(neigh, valid, x)
    if neigh.device.type == "cpu":
        return ell_spmm_ref(neigh, valid, x)
    raise ValueError(f"no ell_spmm for device {neigh.device}")


def _slab(g: CSRGraph, k_max: int, ell):
    if ell is None:
        return ell_pad(g, k_max)
    neigh, valid = ell
    if neigh.shape != (g.n, k_max) or valid.shape != (g.n, k_max):
        raise ValueError(f"ell slab must be [{g.n}, {k_max}], got "
                         f"{tuple(neigh.shape)} and {tuple(valid.shape)}")
    return neigh, valid


def spmm_aggregate(g: CSRGraph, x: torch.Tensor, k_max: int = 16,
                   ell=None) -> torch.Tensor:
    neigh, valid = _slab(g, k_max, ell)
    return spmm_residue(g, x, ell_spmm(neigh, valid, x), k_max)


def spmm_aggregate_ref(g: CSRGraph, x: torch.Tensor, k_max: int = 16,
                       ell=None) -> torch.Tensor:
    """The plain PyTorch aggregation on any device, in x's dtype: what
    ``spmm_aggregate`` computes on a CPU tensor."""
    neigh, valid = _slab(g, k_max, ell)
    y = ell_spmm_ref(neigh, valid, x)
    return spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx, x, y, k_max)
