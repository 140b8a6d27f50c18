"""GIN (Xu et al., arXiv:1810.00826), port of ``repro/models/gnn/gin.py``:
sum aggregation and a learnable eps.

h' = MLP( (1 + eps) * h + sum_{j in N(i)} h_j ). Graph-level readout: sum
pooling of every layer's representation (the paper's jumping-knowledge
readout), a linear classifier per layer, summed.

The neighbour sum of every layer runs through ``distributed/aggregate.py::
owner_gather_scatter`` as the reference's does: without a mesh,
``common.sum_aggregate`` (the ELL slab kernel and its residue fold, forward
and backward) over the adjacency ``build_adjacency`` makes once a batch;
under the sharded step, the same kernels over the rank's own edges. Layer
0 sums the input features, which need no gradient, so a step calls each
kernel ``n_layers`` times forward and ``n_layers - 1`` times backward.
Parameters are a flat dict named as the reference's tree: ``eps``
[n_layers], ``mlps.{i}.{j}.w`` / ``.b`` and ``heads.{i}.w`` / ``.b``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.distributed.aggregate import masked, owner_gather_scatter
from repro_torch.kernels.ell_spmm.ops import spmm_aggregate
from repro_torch.models import layers as L
from repro_torch.models.gnn.common import (Adjacency, GraphBatch,
                                           build_adjacency, global_nodes,
                                           graph_pool, graph_targets)
from repro_torch.models.params import flatten, prefixed, unflatten


@dataclass(frozen=True)
class GINConfig:
    name: str = "gin-tu"
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 64
    n_classes: int = 16
    task: str = "node"         # node | graph
    dtype: str = "float32"


def init_gin(gen: torch.Generator, cfg: GINConfig, device=None) -> dict:
    device = gen.device if device is None else device
    tree = {"eps": torch.zeros((cfg.n_layers,), device=device),
            "mlps": [], "heads": []}
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        tree["mlps"].append(L.mlp_init(gen, [d_in, cfg.d_hidden,
                                             cfg.d_hidden], device=device))
        tree["heads"].append(L.dense(gen, cfg.d_hidden, cfg.n_classes,
                                     bias=True, device=device))
        d_in = cfg.d_hidden
    return flatten(tree)


def gin_param_specs(cfg: GINConfig) -> dict:
    specs = {"eps": (None,)}
    for i in range(cfg.n_layers):
        specs.update(prefixed(f"mlps.{i}", L.mlp_specs(2)))
        specs.update(prefixed(f"heads.{i}",
                              L.dense_specs(("mlp", None), bias=True)))
    return specs


def gin_forward(params: dict, gb: GraphBatch, cfg: GINConfig,
                adj: Adjacency | None = None,
                impl: Callable = spmm_aggregate) -> torch.Tensor:
    """Summed per-layer logits ([N, C] node task, [G, C] graph task).
    ``adj`` passes the batch's adjacency when it is already built; ``impl``
    is the sum aggregation (the kernels by default, ``spmm_aggregate_ref``
    for the plain one)."""
    p = unflatten(params)
    if adj is None:
        adj = build_adjacency(gb)
    n = global_nodes(gb)
    h = gb.feats
    out = None
    for i in range(cfg.n_layers):
        agg = owner_gather_scatter(h, gb.senders, gb.receivers, gb.edge_mask,
                                   masked, n, adj, impl)
        h = (1.0 + p["eps"][i]) * h + agg
        h = L.apply_mlp(p["mlps"][i], h, act="relu")
        h = torch.relu(h)
        pooled = graph_pool(h, gb) if cfg.task == "graph" else h
        logits = L.apply_dense(p["heads"][i], pooled)
        out = logits if out is None else out + logits
    return out


def gin_loss(params: dict, gb: GraphBatch, cfg: GINConfig,
             adj: Adjacency | None = None,
             impl: Callable = spmm_aggregate):
    logits = gin_forward(params, gb, cfg, adj, impl)
    if cfg.task == "graph":
        loss = L.softmax_xent(logits, graph_targets(gb))
    else:
        loss = L.softmax_xent(logits, gb.labels, gb.node_mask)
    return loss, {"xent": loss}
