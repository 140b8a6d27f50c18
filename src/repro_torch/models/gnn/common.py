"""GNN substrate (port of ``repro/models/gnn/common.py``): the graph batch,
segment-op message passing, and the sum aggregation that runs through the
ELL kernels.

``aggregate`` keeps the reference's gather + scatter form (``index_add_``
over an edge index). The sum aggregation of a layer, ``sum_aggregate``,
instead runs through ``kernels.ell_spmm.ops.spmm_aggregate`` (the ELL slab
kernel and its residue fold) over CSRs that ``build_adjacency`` makes once
per batch; its backward is the same aggregation over the transposed graph.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from repro_torch.core.csr import CSRGraph, ell_pad, from_edge_tensors
from repro_torch.device import resolve_device
from repro_torch.distributed import spmd
from repro_torch.kernels.ell_spmm.ops import spmm_aggregate

ELL_K_MAX = 16  # slab width, the reference's spmm_aggregate default


@dataclass
class GraphBatch:
    senders: torch.Tensor    # int32[E]
    receivers: torch.Tensor  # int32[E]
    edge_mask: torch.Tensor  # bool[E]
    feats: torch.Tensor      # f32[N, F]
    pos: torch.Tensor        # f32[N, 3] (synthetic for non-geometric tasks)
    labels: torch.Tensor     # int32[N] node labels
    node_mask: torch.Tensor  # bool[N]
    graph_ids: torch.Tensor  # int32[N], graph membership for pooling
    n_graphs: int = 1

    @property
    def n_nodes(self) -> int:
        return self.feats.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]

    def _replace(self, **kw):
        return dataclasses.replace(self, **kw)


def aggregate(messages: torch.Tensor, receivers: torch.Tensor, n_nodes: int,
              edge_mask: torch.Tensor | None = None,
              op: str = "sum") -> torch.Tensor:
    """Scatter-reduce edge messages to nodes. Under a split mesh the edges
    are the rank's own, ``n_nodes`` the graph's, and the sums (and counts)
    are reduce-scattered to the rank's block of nodes."""
    shape = (-1,) + (1,) * (messages.dim() - 1)
    if edge_mask is not None:
        messages = torch.where(edge_mask.reshape(shape), messages, 0)
    idx = receivers.long()
    out = (n_nodes,) + tuple(messages.shape[1:])
    if op in ("sum", "mean"):
        s = spmd.scatter_nodes(messages.new_zeros(out).index_add(
            0, idx, messages))
        if op == "sum":
            return s
        ones = torch.ones(messages.shape[0], dtype=torch.float32,
                          device=messages.device)
        if edge_mask is not None:
            ones = torch.where(edge_mask, ones, 0.0)
        cnt = spmd.scatter_nodes(ones.new_zeros(n_nodes).index_add(
            0, idx, ones))
        return s / torch.clamp(cnt, min=1.0).reshape(shape)
    if spmd.split() is not None:
        raise NotImplementedError(f"aggregate op={op!r} on a split mesh")
    if op == "max":
        init = messages.new_full(out, float("-inf"))
        expand = idx.reshape(shape).expand_as(messages)
        return init.scatter_reduce(0, expand, messages, "amax")
    raise ValueError(op)


def degrees(gb: GraphBatch) -> torch.Tensor:
    ones = torch.where(gb.edge_mask, 1.0, 0.0)
    return ones.new_zeros(gb.n_nodes).index_add(0, gb.receivers.long(), ones)


def graph_pool(node_values: torch.Tensor, gb: GraphBatch,
               op: str = "sum") -> torch.Tensor:
    """Pool node values to per-graph values: [N, ...] -> [G, ...] (summed
    over the ranks under a split mesh)."""
    if op != "sum":
        raise ValueError(op)
    shape = (-1,) + (1,) * (node_values.dim() - 1)
    vals = torch.where(gb.node_mask.reshape(shape), node_values, 0)
    out = (gb.n_graphs,) + tuple(node_values.shape[1:])
    return spmd.sum_all(vals.new_zeros(out).index_add(
        0, gb.graph_ids.long(), vals))


def synthetic_graph_batch(gen: torch.Generator, n_nodes: int, n_edges: int,
                          d_feat: int, n_classes: int = 16,
                          n_graphs: int = 1,
                          dtype=torch.float32) -> GraphBatch:
    """Random graph batch on the generator's device, drawn as the
    reference draws it: uniform senders and receivers (kept inside their
    graph when ``n_graphs > 1``), standard-normal features and positions,
    uniform labels, every edge and node live. The values are not the
    reference's; the distributions are."""
    dev = gen.device

    def ints(hi, size):
        return torch.randint(0, hi, (size,), generator=gen,
                             dtype=torch.int32, device=dev)

    senders = ints(n_nodes, n_edges)
    receivers = ints(n_nodes, n_edges)
    if n_graphs > 1:
        per = n_nodes // n_graphs
        gid_e = ints(n_graphs, n_edges)
        senders = senders % per + gid_e * per
        receivers = receivers % per + gid_e * per
        graph_ids = torch.repeat_interleave(
            torch.arange(n_graphs, dtype=torch.int32, device=dev),
            per)
        graph_ids = torch.cat([graph_ids, graph_ids.new_full(
            (n_nodes - n_graphs * per,), n_graphs - 1)])
    else:
        graph_ids = torch.zeros((n_nodes,), dtype=torch.int32, device=dev)
    feats = torch.randn((n_nodes, d_feat), generator=gen, dtype=dtype,
                        device=dev)
    pos = torch.randn((n_nodes, 3), generator=gen, dtype=dtype, device=dev)
    return GraphBatch(
        senders=senders, receivers=receivers,
        edge_mask=torch.ones((n_edges,), dtype=torch.bool, device=dev),
        feats=feats, pos=pos, labels=ints(n_classes, n_nodes),
        node_mask=torch.ones((n_nodes,), dtype=torch.bool, device=dev),
        graph_ids=graph_ids, n_graphs=n_graphs)


def graph_batch_from_numpy(batch, device=None) -> GraphBatch:
    """A ``GraphBatch`` on ``device`` (default: the GPU) from any object
    with the same fields holding arrays, e.g. the JAX package's batch."""
    device = resolve_device(device)

    def move(name):
        return torch.from_numpy(np.array(getattr(batch, name))).to(device)

    fields = [f.name for f in dataclasses.fields(GraphBatch)
              if f.name != "n_graphs"]
    return GraphBatch(**{f: move(f) for f in fields},
                      n_graphs=int(batch.n_graphs))


class Adjacency(NamedTuple):
    """The two CSRs and ELL slabs of a batch's live edges: ``fwd`` has a
    row per receiver listing its senders (the aggregation), ``bwd`` a row
    per sender listing its receivers (its transpose, for the backward)."""
    fwd: CSRGraph
    fwd_ell: tuple[torch.Tensor, torch.Tensor]
    bwd: CSRGraph
    bwd_ell: tuple[torch.Tensor, torch.Tensor]
    k_max: int


def edge_adjacency(senders: torch.Tensor, receivers: torch.Tensor,
                   edge_mask: torch.Tensor, n_nodes: int,
                   k_max: int = ELL_K_MAX) -> Adjacency:
    """Both CSRs of the given edges over ``n_nodes`` rows and their slabs,
    built on the edges' device; direction and multi-edges kept. Each CSR
    keeps every edge slot, the masked edges dead past ``row_ptr[n]``
    (``core.csr.from_edge_tensors``), so no value is read: no host sync,
    and meta tensors trace."""
    fwd = from_edge_tensors(receivers, senders, edge_mask, n_nodes)
    bwd = from_edge_tensors(senders, receivers, edge_mask, n_nodes)
    return Adjacency(fwd=fwd, fwd_ell=ell_pad(fwd, k_max), bwd=bwd,
                     bwd_ell=ell_pad(bwd, k_max), k_max=k_max)


def build_adjacency(gb: GraphBatch, k_max: int = ELL_K_MAX) -> Adjacency:
    """``edge_adjacency`` of the batch's edges over all its nodes (under a
    split mesh, over the graph's ``global_nodes``)."""
    return edge_adjacency(gb.senders, gb.receivers, gb.edge_mask,
                          global_nodes(gb), k_max)


def global_nodes(gb: GraphBatch) -> int:
    """The graph's node count: the batch's, times the ranks of the
    ambient mesh's split (``distributed/spmd.py``) when it holds one block
    of them."""
    sp = spmd.split()
    return gb.n_nodes * (1 if sp is None else sp.n)


def graph_targets(gb: GraphBatch) -> torch.Tensor:
    """The graph-level targets, the first ``n_graphs`` node labels of the
    whole graph (all-gathered under a split mesh)."""
    return spmd.gather_all(gb.labels)[:gb.n_graphs]


class SumAggregate(torch.autograd.Function):
    """``y[v] = sum over live edges u -> v of h[u]``; the gradient of h is
    the same sum over the transposed graph, so both directions run the ELL
    kernel and its residue fold (on a CUDA tensor)."""

    @staticmethod
    def forward(ctx, h, adj: Adjacency, impl: Callable):
        ctx.adj, ctx.impl = adj, impl
        return impl(adj.fwd, h.contiguous(), adj.k_max, adj.fwd_ell)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        adj = ctx.adj
        return ctx.impl(adj.bwd, gy.contiguous(), adj.k_max,
                        adj.bwd_ell), None, None


def sum_aggregate(h: torch.Tensor, adj: Adjacency,
                  impl: Callable = spmm_aggregate) -> torch.Tensor:
    """Differentiable sum aggregation through ``impl`` (default: the
    kernels on a CUDA tensor; ``spmm_aggregate_ref`` is the plain one)."""
    return SumAggregate.apply(h, adj, impl)
