"""GCN (Kipf & Welling, arXiv:1609.02907), port of
``repro/models/gnn/gcn.py``: h' = act(D^-1/2 (A + I) D^-1/2 h W).

Parameters are a flat dict named as the reference's tree,
``layers.{i}.w`` [d_in, d_out] and ``layers.{i}.b`` [d_out]. ``norm="sym"``
aggregates ``h * inv_sqrt`` through ``distributed/aggregate.py::
owner_gather_scatter``, as the reference does: without a mesh that is
``common.sum_aggregate`` (the ELL slab kernel and its residue fold, forward
and backward); under the sharded step, the same kernels over a CSR of the
rank's own edges between an all-gather and a reduce-scatter.
``norm="mean"`` keeps the reference's segment mean. ``deg`` is the
in-degree over live edges plus 1, as the reference counts it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from repro_torch.distributed import spmd
from repro_torch.distributed.aggregate import masked, owner_gather_scatter
from repro_torch.kernels.ell_spmm.ops import spmm_aggregate
from repro_torch.models import layers as L
from repro_torch.models.gnn.common import (Adjacency, GraphBatch, aggregate,
                                           build_adjacency, global_nodes)
from repro_torch.models.params import (opt_state_from_numpy,  # noqa: F401
                                       params_from_numpy)


@dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_hidden: int = 16
    d_feat: int = 1433
    n_classes: int = 16
    norm: str = "sym"          # sym | mean
    dtype: str = "float32"


def _dims(cfg: GCNConfig) -> list[int]:
    return [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) \
        + [cfg.n_classes]


def init_gcn(gen: torch.Generator, cfg: GCNConfig, device=None) -> dict:
    """{"layers.{i}.w", "layers.{i}.b"} on the generator's device, or on
    ``device``."""
    dims = _dims(cfg)
    params = {}
    for i in range(len(dims) - 1):
        p = L.dense(gen, dims[i], dims[i + 1], getattr(torch, cfg.dtype),
                    bias=True, device=device)
        params.update({f"layers.{i}.{k}": v for k, v in p.items()})
    return params


def gcn_param_specs(cfg: GCNConfig) -> dict:
    return {f"layers.{i}.{k}": v for i in range(len(_dims(cfg)) - 1)
            for k, v in L.dense_specs(("embed", "mlp"), bias=True).items()}


def gcn_forward(params: dict, gb: GraphBatch, cfg: GCNConfig,
                adj: Adjacency | None = None,
                impl: Callable = spmm_aggregate) -> torch.Tensor:
    """Logits [N, n_classes]. ``adj`` passes the batch's adjacency when it
    is already built; ``impl`` is the sum aggregation (the kernels by
    default, ``spmm_aggregate_ref`` for the plain one)."""
    n = global_nodes(gb)
    if cfg.norm == "sym":
        if adj is None:
            adj = build_adjacency(gb)
        deg = spmd.scatter_nodes(adj.fwd.deg.to(torch.float32)) + 1.0
        inv_sqrt = torch.rsqrt(deg)[:, None]
    h = gb.feats
    for i in range(cfg.n_layers):
        h = L.apply_dense({"w": params[f"layers.{i}.w"],
                           "b": params[f"layers.{i}.b"]}, h)
        if cfg.norm == "sym":
            # the sym-norm factor folds into the node features, so the
            # edge function stays a masked identity
            hs = h * inv_sqrt
            agg = owner_gather_scatter(hs, gb.senders, gb.receivers,
                                       gb.edge_mask, masked, n, adj, impl)
            h = (agg + hs) * inv_sqrt
        else:
            agg = aggregate(spmd.gather_nodes(h)[gb.senders.long()],
                            gb.receivers, n, gb.edge_mask, op="mean")
            h = agg + h
        if i < cfg.n_layers - 1:
            h = torch.relu(h)
    return h


def gcn_loss(params: dict, gb: GraphBatch, cfg: GCNConfig,
             adj: Adjacency | None = None,
             impl: Callable = spmm_aggregate):
    logits = gcn_forward(params, gb, cfg, adj, impl)
    loss = L.softmax_xent(logits, gb.labels, gb.node_mask)
    return loss, {"xent": loss}


class _Dense(nn.Module):
    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class GCN(nn.Module):
    """The model as a module: ``named_parameters()`` gives the same names
    as ``init_gcn``, and ``forward`` runs ``gcn_forward`` over them."""

    def __init__(self, cfg: GCNConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            _Dense(params[f"layers.{i}.w"], params[f"layers.{i}.b"])
            for i in range(cfg.n_layers))

    def forward(self, gb: GraphBatch, adj: Adjacency | None = None):
        return gcn_forward(dict(self.named_parameters()), gb, self.cfg, adj)


# the reference tree carried across, under the names earlier callers use
gcn_params_from_numpy = params_from_numpy
