"""Exchange primitives shared by the distributed engines.

Port of ``repro.core.exchange`` on ``torch.distributed``. The distributed
traversals move two kinds of state between ranks: packed lane words
(``core/packed.py``), which fold under OR, and float lane values (the SSSP
engines' distances and candidates), which fold under MIN. This module is
the one implementation of those moves, so every partition shares a wire
format, a compression rule and a byte count:

* ``allreduce_or``: the bitwise-OR all-reduce, the ``psum`` of bitmasks.
  ``torch.distributed`` has no OR reduction that both gloo and NCCL
  implement, so it is an all-gather and an OR fold, as in the reference.
  It is the 1-D engine's whole frontier exchange.
* ``gather_words``: all-gather per-rank word slices along one mesh axis,
  optionally through the sparse (index, word) codec of
  ``distributed.compression``. The sparse or dense form is chosen per
  gather group: the ranks gather their nonzero counts first and take the
  sparse form only when every slice fits the budget, so a group ships one
  form and the byte count follows it.
* ``exchange_expand`` / ``exchange_reduce_or``: the two moves of the
  Buluc-Madduri 2-D decomposition, over ``gather_words``.
* ``allreduce_min``, ``gather_values``, ``exchange_expand_values`` and
  ``exchange_reduce_min``: the MIN side, the same moves for float values
  over the value codec, whose empty entry is ``inf``.
* ``psum`` / ``pmin`` / ``pmax``: ``all_reduce`` over a group, as the
  reference's ``lax`` collectives.

A ``MeshComm`` names the group a collective runs over and this rank's place
in it: ``mesh_comm(mesh)`` spans the whole mesh, its axes flattened (the
1-D engines' block order, ``mesh.mesh.flatten()``), ``mesh_comm(mesh,
axis)`` one axis. Gathered slices are stacked in that order. A ``GridComm``
holds the groups of a ``("row", "col")`` grid mesh that the 2-D engines
use (``grid_comm``).

A compressed gather reads its group's entry counts on the host, to choose
the form: one host sync per compressed exchange, where the dense form
makes none.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.distributed.compression import (DENSE_THRESHOLD,
                                                 _COUNT_BYTES, _IDX_BYTES,
                                                 compress_values,
                                                 compress_words,
                                                 decompress_values,
                                                 decompress_words,
                                                 sparse_budget)

__all__ = [
    "GridComm", "MeshComm", "allreduce_min", "allreduce_or",
    "exchange_expand", "exchange_expand_values", "exchange_reduce_min",
    "exchange_reduce_or", "gather_values", "gather_words", "grid_comm",
    "grid_sum", "mesh_comm", "pmax", "pmin", "psum", "sparse_budget",
]

# all_gather_into_tensor is named all_gather_single in newer torch
_gather_into = (getattr(dist, "all_gather_single", None)
                or dist.all_gather_into_tensor)


class MeshComm(NamedTuple):
    """A collective group over some of a mesh's ranks."""
    group: object            # the ProcessGroup
    size: int                # ranks in the group
    index: int               # this rank's slot in the mesh order
    order: tuple | None      # group rank of each slot; None = the same


def mesh_comm(mesh, axis=None) -> MeshComm:
    """The group of ``mesh`` along ``axis`` (a name or an index), or over
    all its axes flattened when ``axis`` is None. A flattened mesh of more
    than one axis must span the whole process group, whose default group it
    then uses."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.mesh.tolist()}")
    full = mesh.mesh
    if axis is None:
        members = full.flatten().tolist()
        if full.dim() == 1:
            group = mesh.get_group(0)
        elif sorted(members) == list(range(dist.get_world_size())):
            group = dist.group.WORLD
        else:
            raise ValueError(
                "a mesh of more than one axis must span the whole process "
                "group to be flattened; pass a 1-D mesh")
    else:
        dim = (mesh.mesh_dim_names.index(axis) if isinstance(axis, str)
               else int(axis))
        members = full[tuple(slice(None) if d == dim else c
                             for d, c in enumerate(coord))].tolist()
        group = mesh.get_group(dim)
    ranks = dist.get_process_group_ranks(group)
    order = tuple(ranks.index(r) for r in members)
    if order == tuple(range(len(members))):
        order = None
    return MeshComm(group=group, size=len(members),
                    index=members.index(dist.get_rank()), order=order)


class GridComm(NamedTuple):
    """The groups of a ``("row", "col")`` grid mesh, for rank ``(i, j)``:
    ``row`` gathers along "row" (the ranks of grid column ``j``, in grid-row
    order), ``col`` along "col" (the ranks of grid row ``i``), ``world``
    spans the grid when it is the whole process group (else None)."""
    row: MeshComm
    col: MeshComm
    world: MeshComm | None
    i: int                   # grid row of this rank
    j: int                   # grid column of this rank

    @property
    def pr(self) -> int:
        return self.row.size

    @property
    def pc(self) -> int:
        return self.col.size


def grid_comm(mesh) -> GridComm:
    """The ``GridComm`` of a ``("row", "col")`` mesh on this rank."""
    row, col = mesh_comm(mesh, "row"), mesh_comm(mesh, "col")
    members = sorted(mesh.mesh.flatten().tolist())
    world = (mesh_comm(mesh) if members == list(range(dist.get_world_size()))
             else None)
    return GridComm(row=row, col=col, world=world, i=row.index, j=col.index)


def grid_sum(x: torch.Tensor, grid: GridComm) -> torch.Tensor:
    """Element-wise sum over every rank of the grid: one all-reduce over
    the process group when the grid spans it, else over "col" and then
    "row"."""
    if grid.world is not None:
        return psum(x, grid.world)
    return psum(psum(x, grid.col), grid.row)


def all_gather(x: torch.Tensor, comm: MeshComm) -> torch.Tensor:
    """Stack every rank's ``x`` (same shape and dtype everywhere) in mesh
    order: ``[comm.size, *x.shape]``."""
    flat = x.reshape(-1).contiguous()
    out = torch.empty(comm.size * flat.numel(), dtype=x.dtype,
                      device=x.device)
    _gather_into(out, flat, group=comm.group)
    out = out.view((comm.size,) + tuple(x.shape))
    if comm.order is not None:
        out = out[list(comm.order)]
    return out


def _reduce(x: torch.Tensor, comm: MeshComm, op) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=op, group=comm.group)
    return out


def psum(x: torch.Tensor, comm: MeshComm) -> torch.Tensor:
    """Element-wise sum over the group (a new tensor)."""
    return _reduce(x, comm, dist.ReduceOp.SUM)


def pmin(x: torch.Tensor, comm: MeshComm) -> torch.Tensor:
    """Element-wise minimum over the group (a new tensor)."""
    return _reduce(x, comm, dist.ReduceOp.MIN)


def pmax(x: torch.Tensor, comm: MeshComm) -> torch.Tensor:
    """Element-wise maximum over the group (a new tensor)."""
    return _reduce(x, comm, dist.ReduceOp.MAX)


def _or_fold(stacked: torch.Tensor) -> torch.Tensor:
    """OR-fold a gathered ``[ndev, ...]`` stack along its rank dim."""
    out = stacked[0]
    for d in range(1, stacked.shape[0]):
        out = out | stacked[d]
    return out


def _min_fold(stacked: torch.Tensor) -> torch.Tensor:
    """MIN-fold a gathered ``[ndev, ...]`` stack along its rank dim."""
    out = stacked[0]
    for d in range(1, stacked.shape[0]):
        out = torch.minimum(out, stacked[d])
    return out


def allreduce_min(vals: torch.Tensor, comm: MeshComm) -> torch.Tensor:
    """Element-wise MIN all-reduce of float lane values over the group,
    dense, as an all-gather and a fold like ``allreduce_or``. ``inf`` is
    the identity; float32 ``min`` is exact in any order (the engines make
    no NaN), so the fold order cannot change a bit."""
    return _min_fold(all_gather(vals, comm))


def allreduce_or(words: torch.Tensor, comm: MeshComm) -> torch.Tensor:
    """Bitwise-OR all-reduce of packed lane words over the group, dense:
    the 1-D engine's frontier exchange, where each rank ORs its placed row
    block into the replicated ``[n, W]`` frontier."""
    return _or_fold(all_gather(words, comm))


def _gather(own: torch.Tensor, axis: MeshComm, compress: bool,
            threshold: float, codec):
    """All-gather ``own`` along ``axis``, through ``codec`` = (compress,
    decompress) when ``compress`` and every slice of the group fits the
    sparse budget. Returns ``(stacked [ndev, *own.shape], bytes)``."""
    itemsize = own.element_size()
    total = own.numel()
    dense = axis.size * total * itemsize
    if not compress:
        return all_gather(own, axis), dense
    pack, unpack = codec
    budget = sparse_budget(total, threshold)
    idx, payload, count = pack(own, budget)
    counts = all_gather(count.reshape(1), axis).view(-1).tolist()
    if max(counts) > budget:
        return all_gather(own, axis), dense
    g_idx, g_pay = all_gather(idx, axis), all_gather(payload, axis)
    stacked = torch.stack([unpack(g_idx[d], g_pay[d], total)
                           .reshape(own.shape) for d in range(axis.size)])
    return stacked, sum(_COUNT_BYTES + c * (_IDX_BYTES + itemsize)
                        for c in counts)


def gather_words(own: torch.Tensor, axis: MeshComm, compress: bool = False,
                 threshold: float = DENSE_THRESHOLD):
    """All-gather a per-rank word slice along ``axis`` (a ``MeshComm``).

    Returns ``(stacked words [ndev, *own.shape], bytes)``: ``bytes`` is the
    payload the group shipped in this call, summed over its ranks, the same
    on every rank of the group (a host int).

    ``compress=False`` ships the dense slice. ``compress=True`` runs the
    density switch: each rank packs its slice into a ``sparse_budget(total,
    threshold)``-slot buffer, the group gathers the nonzero counts (one
    small collective and a host read), and if every slice fits the budget
    the group gathers the (index, word) buffers and unpacks them; otherwise
    it gathers the dense slices."""
    return _gather(own, axis, compress, threshold,
                   (compress_words, decompress_words))


def gather_values(own: torch.Tensor, axis: MeshComm, compress: bool = False,
                  threshold: float = DENSE_THRESHOLD):
    """All-gather a per-rank float value slice along ``axis``: the value
    twin of ``gather_words``, whose density switch counts the finite
    entries (a relaxation candidate is ``inf`` wherever no relaxation fired
    this step, so the compressed bytes follow the active frontier).
    Returns ``(stacked values [ndev, *own.shape], bytes)``."""
    return _gather(own, axis, compress, threshold,
                   (compress_values, decompress_values))


def exchange_expand(own: torch.Tensor, axis: MeshComm,
                    compress: bool = False,
                    threshold: float = DENSE_THRESHOLD):
    """Expand-side exchange of the 2-D decomposition: gather the frontier
    chunks of the ranks along ``axis`` and concatenate them in axis order.
    Returns ``(words [ndev * rows, W], bytes)``."""
    stacked, nbytes = gather_words(own, axis, compress, threshold)
    return stacked.reshape((-1,) + tuple(own.shape[1:])), nbytes


def exchange_reduce_or(partial: torch.Tensor, axis: MeshComm,
                       compress: bool = False,
                       threshold: float = DENSE_THRESHOLD):
    """Reduce-side exchange of the 2-D decomposition: OR-fold the partial
    new-frontier words of the ranks along ``axis`` (the same on each).
    Returns ``(words like partial, bytes)``."""
    stacked, nbytes = gather_words(partial, axis, compress, threshold)
    return _or_fold(stacked), nbytes


def exchange_expand_values(own: torch.Tensor, axis: MeshComm,
                           compress: bool = False,
                           threshold: float = DENSE_THRESHOLD):
    """Expand-side value exchange of the 2-D decomposition: gather the
    value chunks of the ranks along ``axis`` and concatenate them in axis
    order. Returns ``(values [ndev * rows, L], bytes)``."""
    stacked, nbytes = gather_values(own, axis, compress, threshold)
    return stacked.reshape((-1,) + tuple(own.shape[1:])), nbytes


def exchange_reduce_min(partial: torch.Tensor, axis: MeshComm,
                        compress: bool = False,
                        threshold: float = DENSE_THRESHOLD):
    """Reduce-side value exchange: MIN-fold the partial relaxation
    candidates of the ranks along ``axis`` (the same on each). Returns
    ``(values like partial, bytes)``."""
    stacked, nbytes = gather_values(partial, axis, compress, threshold)
    return _min_fold(stacked), nbytes
