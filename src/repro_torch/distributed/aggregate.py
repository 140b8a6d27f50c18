"""Owner-aligned gather/scatter aggregation (port of
``repro/distributed/aggregate.py``).

The reference's structural fix for collective-bound message passing: in
place of the partitioner's own schedule for the ``H[senders]`` gather and
the ``segment_sum`` scatter, the exchange is explicit, the pattern of the
distributed BFS bottom-up:

  forward : one all-gather of the node features (payload n * feat bytes)
            and one reduce-scatter of the edge owners' partial sums;
  backward: their transposes (reduce-scatter, all-gather); nothing else
            crosses the links.

Under the sharded step (``train/sharded.py``) every rank holds a block of
the nodes and a block of the edges (global node ids), and the collectives
run over all the axes of the ambient mesh jointly
(``distributed/spmd.py``). The rank's local work, ``local_aggregate``, is
the sum of its edges' messages into all n nodes: for a plain masked sum
(``edge_fn`` is ``masked``, GCN's and GIN's) it runs through a CSR over the
rank's own edges and ``spmm_aggregate`` (the ELL slab kernel and its
residue fold on a CUDA tensor, forward and backward); for any other
``edge_fn`` (MACE's message) it gathers and ``index_add``s.

Without an ambient mesh, on a mesh of one device, or when the caller did
not split the nodes (``node_feats`` holds all ``n_nodes`` rows: its n or
edge count did not divide by the mesh size), the unsharded path runs:
``common.sum_aggregate`` for ``masked``, gather and ``index_add``
otherwise.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import ambient_mesh, mesh_size
from repro_torch.kernels.ell_spmm.ops import spmm_aggregate
from repro_torch.models.gnn.common import (Adjacency, edge_adjacency,
                                           sum_aggregate)


def masked(hj: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The edge function of a plain masked sum: the sender's features on a
    live edge, zeros on a masked one."""
    return torch.where(mask[:, None], hj, 0.0)


def local_aggregate(h_full: torch.Tensor, senders: torch.Tensor,
                    receivers: torch.Tensor, edge_data, edge_fn: Callable,
                    n_nodes: int, adj: Adjacency | None = None,
                    impl: Callable = spmm_aggregate) -> torch.Tensor:
    """Sum over the given edges of ``edge_fn(h_full[senders], edge_data)``
    into ``[n_nodes, ...]`` (``h_full`` holds all n rows). For ``masked``
    the sum runs through ``adj`` (built over these edges when None) and
    ``impl``, differentiably."""
    if edge_fn is masked:
        if adj is None:
            adj = edge_adjacency(senders, receivers, edge_data, n_nodes)
        return sum_aggregate(h_full, adj, impl)
    msgs = edge_fn(h_full[senders.long()], edge_data)
    return msgs.new_zeros((n_nodes,) + tuple(msgs.shape[1:])).index_add(
        0, receivers.long(), msgs)


def owner_gather_scatter(node_feats: torch.Tensor, senders: torch.Tensor,
                         receivers: torch.Tensor, edge_data,
                         edge_fn: Callable, n_nodes: int,
                         adj: Adjacency | None = None,
                         impl: Callable = spmm_aggregate) -> torch.Tensor:
    """A[v] = sum over edges e with receivers[e] = v of
    ``edge_fn(node_feats[senders[e]], edge_data[e])``.

    ``edge_data`` is an [E, ...] tensor or a tuple of them, on the edge
    dimension alongside ``senders``; ``edge_fn(hj, edge_data)`` maps the
    gathered sender features to messages. Under a mesh of N > 1 devices
    ``node_feats`` is this rank's block of ``n_nodes / N`` rows and the
    edges are its own; the result is its block of A. ``adj`` passes the
    CSRs of these edges when already built (``masked`` only)."""
    mesh = ambient_mesh()
    n_dev = mesh_size(mesh)
    if (n_dev <= 1 or n_nodes % n_dev
            or node_feats.shape[0] == n_nodes):
        return local_aggregate(node_feats, senders, receivers, edge_data,
                               edge_fn, n_nodes, adj, impl)
    h_full = spmd.gather_nodes(node_feats)                 # [n, ...]
    part = local_aggregate(h_full, senders, receivers, edge_data, edge_fn,
                           n_nodes, adj, impl)             # local edges
    return spmd.scatter_nodes(part)                        # own block
