"""EGNN (Satorras et al., arXiv:2102.09844), port of
``repro/models/gnn/egnn.py``: an E(n)-equivariant GNN.

m_ij = phi_e(h_i, h_j, ||x_i - x_j||^2)
x_i' = x_i + mean_j (x_i - x_j) phi_x(m_ij)
h_i' = h_i + phi_h(h_i, sum_j m_ij)

Scalars only in the MLPs; coordinates move along relative vectors, so the
model is exactly equivariant to rotations and translations. Both
aggregations scatter per-edge messages (``common.aggregate``, mean for the
coordinates, sum for the features); under the sharded step each rank's
edges read both ends from all-gathered features and positions, and the
sums are reduce-scattered to the rank's nodes. Parameters are a flat dict
named as the reference's tree: ``embed.w`` / ``.b``,
``layers.{i}.{phi_e,phi_x,phi_h}.{j}.w`` / ``.b`` and ``readout.{j}.w`` /
``.b``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.nn import functional as F

from repro_torch.distributed import spmd
from repro_torch.models import layers as L
from repro_torch.models.gnn.common import (GraphBatch, aggregate,
                                           global_nodes, graph_pool,
                                           graph_targets)
from repro_torch.models.params import flatten, prefixed, unflatten


@dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 64
    dtype: str = "float32"


def init_egnn(gen: torch.Generator, cfg: EGNNConfig, device=None) -> dict:
    d = cfg.d_hidden
    tree = {"embed": L.dense(gen, cfg.d_feat, d, bias=True, device=device),
            "layers": []}
    for _ in range(cfg.n_layers):
        tree["layers"].append(
            {"phi_e": L.mlp_init(gen, [2 * d + 1, d, d], device=device),
             "phi_x": L.mlp_init(gen, [d, d, 1], device=device),
             "phi_h": L.mlp_init(gen, [2 * d, d, d], device=device)})
    tree["readout"] = L.mlp_init(gen, [d, d, 1], device=device)
    return flatten(tree)


def egnn_param_specs(cfg: EGNNConfig) -> dict:
    specs = prefixed("embed", L.dense_specs(("embed", "mlp"), bias=True))
    for i in range(cfg.n_layers):
        for name in ("phi_e", "phi_x", "phi_h"):
            specs.update(prefixed(f"layers.{i}.{name}", L.mlp_specs(2)))
    specs.update(prefixed("readout", L.mlp_specs(2)))
    return specs


def egnn_forward(params: dict, gb: GraphBatch, cfg: EGNNConfig):
    """Returns (h [N, d], x [N, 3], energy [G])."""
    p = unflatten(params)
    h = L.apply_dense(p["embed"], gb.feats)
    x = gb.pos
    n = global_nodes(gb)
    snd, rcv = gb.senders.long(), gb.receivers.long()
    for lp in p["layers"]:
        # both ends of the rank's edges (all the nodes under a split mesh)
        x_all, h_all = spmd.gather_nodes(x), spmd.gather_nodes(h)
        diff = x_all[rcv] - x_all[snd]
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = L.apply_mlp(lp["phi_e"],
                        torch.cat([h_all[rcv], h_all[snd], d2], -1),
                        act="silu")
        m = F.silu(m)
        w = L.apply_mlp(lp["phi_x"], m, act="silu")
        x = x + aggregate(diff * w, gb.receivers, n, gb.edge_mask, op="mean")
        agg = aggregate(m, gb.receivers, n, gb.edge_mask)
        h = h + L.apply_mlp(lp["phi_h"], torch.cat([h, agg], -1), act="silu")
    e_node = L.apply_mlp(p["readout"], h, act="silu")[:, 0]
    return h, x, graph_pool(e_node, gb)


def egnn_loss(params: dict, gb: GraphBatch, cfg: EGNNConfig):
    _, _, energy = egnn_forward(params, gb, cfg)
    target = graph_targets(gb).to(torch.float32)
    loss = spmd.split_mean((energy - target) ** 2)
    return loss, {"mse": loss}
