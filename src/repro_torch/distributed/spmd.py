"""Explicit SPMD for the sharded train step (``train/sharded.py``).

The reference's sharded step is one global program that GSPMD partitions
over the mesh. The port's runs the unsharded model code on every rank, each
on its own block of the batch, under ``sharding.use_mesh(mesh)``:

  * a graph's nodes and its edges in N contiguous blocks, N the mesh size
    and the block of the rank at flat index ``i * M + j`` (data index i,
    model index j; the order of the DTensor placements ``Shard(0)`` on
    every axis);
  * an LM's rows over the batch axes ("pod", "data") and its sequence in M
    chunks over the "model" axis;
  * DIEN's rows over all N ranks.

What crosses blocks goes through the functions below, which the model code
calls; without an ambient mesh each is the unsharded operation. Each rank's
loss is its share of the global loss and the shares sum to it
(``split_mean``: a local sum over a global count). A collective's backward
is its transpose (all-gather and reduce-scatter, all-reduce and
all-reduce, a replicated use and a sum), so the gradient of a tensor that
several ranks use is summed over them, and nothing else crosses the links.
The collectives are ``torch.distributed._functional_collectives``: they run
over NCCL, gloo and a fake process group on meta tensors alike.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, NamedTuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import Shard

from repro_torch.distributed.sharding import ambient_mesh, axis_sizes

# all_gather_tensor / reduce_scatter_tensor are named *_single in newer torch
_AG = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
_RS = (getattr(funcol, "reduce_scatter_single", None)
       or funcol.reduce_scatter_tensor)
_BATCH_AXES = ("pod", "data")


def _wait(t: torch.Tensor) -> torch.Tensor:
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _run(x: torch.Tensor, steps) -> torch.Tensor:
    """Apply (kind, dim, group) steps in order: "gather" all-gathers along
    ``dim``, "scatter" reduce-scatters (sum) along it, "sum" all-reduces,
    "bcast" is a use of a value the group already shares (the identity)."""
    for kind, dim, group in steps:
        if kind == "gather":
            x = _wait(_AG(x.contiguous(), dim, group))
        elif kind == "scatter":
            x = _wait(_RS(x.contiguous(), "sum", dim, group))
        elif kind == "sum":
            x = _wait(funcol.all_reduce(x.contiguous(), "sum", group))
    return x


_TRANSPOSE = {"gather": "scatter", "scatter": "gather", "sum": "sum",
              "bcast": "sum"}


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, steps):
        ctx.steps = steps
        return _run(x, steps)

    @staticmethod
    def backward(ctx, gy):
        return _run(gy, [(_TRANSPOSE[k], d, g)
                         for k, d, g in reversed(ctx.steps)]), None


def _exchange(x: torch.Tensor, steps) -> torch.Tensor:
    """``_run(x, steps)`` whose backward runs the transposed steps in the
    reverse order."""
    steps = tuple(steps)
    return _Exchange.apply(x, steps) if steps else x


class Split(NamedTuple):
    """How the ambient mesh splits the work: ``n`` ranks, this one at flat
    index ``rank = data_index * model + model_index``."""
    mesh: Any
    n: int
    rank: int
    data: int            # ranks along the batch axes
    data_index: int
    model: int           # ranks along the "model" axis (1 without one)
    model_index: int


def split(mesh=None) -> Split | None:
    """``mesh``'s (default: the ambient mesh's) split, or None without a
    mesh. Its axes are batch axes ("pod", "data") and then "model", as
    ``launch/mesh.py`` names them."""
    mesh = ambient_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    sizes = axis_sizes(mesh)
    names = list(sizes)
    if names != [a for a in (*_BATCH_AXES, "model") if a in sizes]:
        raise ValueError(f"mesh axes {names}: expected batch axes "
                         f"{_BATCH_AXES} and then 'model'")
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the mesh")
    data_index = 0
    for a, c in zip(names, coord):
        if a in _BATCH_AXES:
            data_index = data_index * sizes[a] + c
    m = sizes.get("model", 1)
    j = coord[names.index("model")] if "model" in sizes else 0
    n = math.prod(sizes.values())
    return Split(mesh, n, data_index * m + j, n // m, data_index, m, j)


def _axes(sp: Split) -> list:
    return [(sp.mesh, a) for a in range(len(axis_sizes(sp.mesh)))]


def gather_nodes(x: torch.Tensor) -> torch.Tensor:
    """All ranks' blocks along dim 0, in flat-rank order (the rank's own
    block without a mesh); the backward reduce-scatters."""
    sp = split()
    if sp is None:
        return x
    return _exchange(x, [("gather", 0, g) for g in reversed(_axes(sp))])


def scatter_nodes(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the ranks and keep this rank's block of dim 0 (``x``
    itself without a mesh); the backward all-gathers."""
    sp = split()
    if sp is None:
        return x
    return _exchange(x, [("scatter", 0, g) for g in _axes(sp)])


def sum_all(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, differentiable (``x`` without a mesh)."""
    sp = split()
    if sp is None:
        return x
    return _exchange(x, [("sum", None, g) for g in _axes(sp)])


def global_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum of a value over the ranks of ``mesh`` (default: the ambient
    mesh), outside autograd."""
    sp = split(mesh)
    x = x.detach()
    if sp is None:
        return x
    return _run(x, [("sum", None, g) for g in _axes(sp)])


def axes_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over the ranks along mesh ``axes`` (indices), outside
    autograd."""
    return _run(x.detach(), [("sum", None, (mesh, a)) for a in axes])


def gather_all(x: torch.Tensor) -> torch.Tensor:
    """All ranks' ``x`` stacked along dim 0 in flat-rank order, outside
    autograd (``x`` without a mesh)."""
    sp = split()
    x = x.detach()
    if sp is None:
        return x
    return _run(x, [("gather", 0, g) for g in reversed(_axes(sp))])


def gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model axis' chunks of ``x`` along ``dim`` (``x`` itself without
    a model axis of more than one rank); the backward reduce-scatters."""
    sp = split()
    if sp is None or sp.model == 1:
        return x
    axis = list(axis_sizes(sp.mesh)).index("model")
    return _exchange(x, [("gather", dim, (sp.mesh, axis))])


def model_reduce(x: torch.Tensor, op: str) -> torch.Tensor:
    """All-reduce ``op`` ("sum", "max") over the model axis, outside
    autograd (``x`` without a model axis of more than one rank)."""
    sp = split()
    if sp is None or sp.model == 1:
        return x
    axis = list(axis_sizes(sp.mesh)).index("model")
    return _wait(funcol.all_reduce(x.contiguous(), op, (sp.mesh, axis)))


def seq_slice(s: int) -> tuple[int, int]:
    """(offset, length) of this rank's chunk of a length-``s`` sequence:
    the model axis splits it in equal chunks; (0, s) without one."""
    sp = split()
    if sp is None or sp.model == 1:
        return 0, s
    if s % sp.model:
        raise ValueError(f"sequence {s} does not split over model="
                         f"{sp.model}")
    c = s // sp.model
    return sp.model_index * c, c


def split_mean(x: torch.Tensor, mask: torch.Tensor | None = None):
    """The mean of ``x`` (over ``mask``'s live entries, at least one) over
    the whole split: this rank's sum over the global count. Without a mesh,
    the unsharded expression."""
    sp = split()
    if mask is None:
        if sp is None:
            return torch.mean(x)
        num = torch.sum(x)
        den = torch.full((), float(x.numel()), dtype=torch.float32,
                         device=x.device)
    else:
        mask = mask.to(torch.float32)
        num, den = torch.sum(x * mask), torch.sum(mask)
        if sp is None:
            return num / torch.clamp(den, min=1.0)
    return num / torch.clamp(global_sum(den), min=1.0)


def gather_param(t: torch.Tensor, placements, mesh) -> torch.Tensor:
    """The whole tensor from this rank's shard ``t`` (DTensor
    ``placements`` on ``mesh``): all-gathers over its sharded axes. The
    backward reduce-scatters over those and sums over the replicated
    ones: the gradient of the shard, summed over every rank's use."""
    steps = [("gather", p.dim, (mesh, a)) if p.is_shard()
             else ("bcast", None, (mesh, a))
             for a, p in reversed(list(enumerate(placements)))]
    return _exchange(t, steps)


# a stack of (parameter name -> placements, mesh) of the step's shards,
# while the sharded step runs a model that gathers its parameters where it
# uses them; process-wide, as ``sharding.use_mesh``'s, for autograd's
# backward thread
_PARAMS: list = [None]


@contextlib.contextmanager
def param_shards(placements: dict, mesh):
    """Inside the block, ``full(name, t)`` gathers parameter ``name``'s
    shard ``t`` by ``placements[name]`` on ``mesh``."""
    _PARAMS.append((placements, mesh))
    try:
        yield
    finally:
        _PARAMS.pop()


def full(name: str, t: torch.Tensor, stacked: bool = False):
    """Parameter ``name`` whole from its shard ``t`` inside
    ``param_shards`` (``t`` itself outside it, or for a name it does not
    hold). ``stacked``: ``t`` is one layer's slice of a tensor stacked over
    layers in dim 0, which is never sharded."""
    reg = _PARAMS[-1]
    if reg is None or name not in reg[0]:
        return t
    placements, mesh = reg[0][name], reg[1]
    if stacked:
        placements = [Shard(p.dim - 1) if p.is_shard() else p
                      for p in placements]
    return gather_param(t, placements, mesh)
