"""Semiring abstraction over the lane-batched traversal step.

Port of ``repro.traversal.semiring``. Every traversal is one masked
multi-lane semiring SpMV:

    out[v, l] = ADD_{e in row v} ( vals[col_idx[e], l]  MUL  w[e] )

``TROPICAL`` (min, +) gives shortest paths (one relax round of
delta-stepping per SpMV, ``repro_torch.traversal.sssp``); ``PLUS_TIMES``
(+, *) weighted aggregation; ``BOOLEAN`` (|, &) over uint8 lanes the packed
engines' own algebra in dense form.

Two execution strategies, as in the reference:

* ``segment_reduce`` / ``semiring_spmv``: edge-parallel over all slots, in
  plain torch (a 1-D ``index_reduce_``/``index_add_`` by owner row, where
  the reference runs an ``associative_scan``);
* ``tropical_relax(impl="pallas")``: the ``semiring_relax`` kernel over
  each row's first ``max_pos`` neighbours, then the ``relax_fallback``
  kernel over the deeper rows' residue. On a CUDA graph these are the two
  hand-written kernels; on a CPU graph their plain versions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.core.csr import CSRGraph
from repro_torch.kernels.relax_fallback.ops import relax_fallback
from repro_torch.kernels.semiring_relax.ops import semiring_relax

__all__ = ["BOOLEAN", "PLUS_TIMES", "SEMIRINGS", "Semiring", "TROPICAL",
           "segment_reduce", "semiring_spmv", "tropical_relax"]

INF = float("inf")


@dataclass(frozen=True)
class Semiring:
    """(ADD, MUL, zero, one) with ADD associative and commutative, ``zero``
    the ADD identity (and MUL annihilator), ``one`` the MUL identity;
    ``dtype`` is the lane-value type. ``reduce`` names the segment
    reduction that computes ADD over a row: "amin", "sum" or "or"."""
    name: str
    add: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    zero: float
    one: float
    dtype: torch.dtype
    reduce: str

    def zeros(self, shape, device=None) -> torch.Tensor:
        return torch.full(shape, self.zero, dtype=self.dtype, device=device)


TROPICAL = Semiring("tropical", torch.minimum, torch.add, zero=INF, one=0.0,
                    dtype=torch.float32, reduce="amin")
PLUS_TIMES = Semiring("plus_times", torch.add, torch.mul, zero=0.0, one=1.0,
                      dtype=torch.float32, reduce="sum")
# dense boolean lanes as uint8 0/1; the packed engines run the same algebra
# 32 lanes per word
BOOLEAN = Semiring("boolean", torch.bitwise_or, torch.bitwise_and, zero=0,
                   one=1, dtype=torch.uint8, reduce="or")

SEMIRINGS = {sr.name: sr for sr in (BOOLEAN, TROPICAL, PLUS_TIMES)}


def segment_reduce(vals: torch.Tensor, row_ptr: torch.Tensor,
                   sr: Semiring) -> torch.Tensor:
    """Per-CSR-row semiring ADD of edge-lane values [m, L] -> [n, L].

    Slot e belongs to the row v with ``row_ptr[v] <= e < row_ptr[v+1]``;
    slots outside ``[row_ptr[0], row_ptr[-1])`` belong to no row, as the
    reference's scan reads them out nowhere. Empty rows give ``sr.zero``.
    The reduction is a 1-D-indexed ``index_reduce_`` (min), ``index_add_``
    (sum: the order differs from the reference's scan, so sums agree to
    rounding) or, for OR, one ``amax`` per bit."""
    m = vals.shape[0]
    n = row_ptr.shape[0] - 1
    out = torch.full((n,) + tuple(vals.shape[1:]), sr.zero, dtype=vals.dtype,
                     device=vals.device)
    if m == 0 or n == 0:
        return out
    e = torch.arange(m, dtype=torch.int32, device=vals.device)
    row = torch.searchsorted(row_ptr, e, right=True) - 1
    owned = (row >= 0) & (row < n)
    row = row.clamp(0, n - 1)
    owned = owned.reshape((m,) + (1,) * (vals.dim() - 1))
    contrib = torch.where(owned, vals, torch.tensor(sr.zero, dtype=vals.dtype,
                                                    device=vals.device))
    if sr.reduce == "amin":
        return out.index_reduce_(0, row, contrib, "amin")
    if sr.reduce == "sum":
        return out.index_add_(0, row, contrib)
    if sr.reduce == "or":
        for bit in range(8 * vals.element_size()):
            plane = torch.zeros_like(out).index_reduce_(
                0, row, (contrib >> bit) & 1, "amax")
            out |= plane << bit
        return out
    raise ValueError(f"unknown segment reduction {sr.reduce!r}")


def semiring_spmv(g: CSRGraph, vals: torch.Tensor, weights,
                  sr: Semiring) -> torch.Tensor:
    """One lane-batched semiring SpMV: ``out[v, l] = ADD_e vals[col_e, l]
    MUL w_e`` over row v's edge slots. ``vals`` is [nf, L] (any nf >= 1)
    (rows are local, ``col_idx`` indexes ``vals``); ``weights`` is [m] or
    None for the adjacency pattern (every edge weighs ``sr.one``)."""
    contrib = vals[g.col_idx.clamp(0, vals.shape[0] - 1)]   # [m, L]
    if weights is not None:
        contrib = sr.mul(contrib, weights.to(vals.dtype)[:, None])
    return segment_reduce(contrib, g.row_ptr, sr)


def tropical_relax(g: CSRGraph, weights: torch.Tensor, vals: torch.Tensor,
                   max_pos: int = 8, impl: str = "xla") -> torch.Tensor:
    """Masked min-plus gather-relax: ``out[v, l] = min_e vals[col_e, l] +
    w_e`` (+inf where nothing relaxes). Callers mask inactive sources with
    +inf values and excluded edges with +inf weights.

    ``impl='xla'`` (the reference's name) runs the plain edge-parallel
    ``semiring_spmv``; ``impl='pallas'`` runs ``semiring_relax`` over each
    row's first ``max_pos`` neighbours, then ``relax_fallback`` over the
    deeper rows: two kernel launches on a CUDA graph. The fold leaves rows
    of degree <= ``max_pos`` unchanged, so it runs without first asking
    the device whether any row is deeper (the reference's ``lax.cond``)."""
    if g.m == 0:
        return torch.full((g.n, vals.shape[1]), INF, dtype=vals.dtype,
                          device=vals.device)
    if impl == "pallas":
        acc = semiring_relax(g.row_ptr, g.col_idx, weights, vals, max_pos)
        return relax_fallback(g.row_ptr, g.src_idx, g.col_idx, weights, vals,
                              acc, max_pos)
    return semiring_spmv(g, vals, weights, TROPICAL)
