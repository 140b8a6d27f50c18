"""Reduced per-arch configs (port of ``repro/configs/reduced.py``): same
family and structure, small dims, for the CPU tests and quick runs. The
GNN and recsys families are ported; the LMs raise until ROADMAP A10 (d)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import Arch, Shape, get_arch


def _gnn_reduced(arch: Arch) -> Arch:
    cfg = arch.model_cfg
    over = dict(n_layers=2)
    if hasattr(cfg, "d_hidden"):
        over["d_hidden"] = 16
    small = dataclasses.replace(cfg, **over)
    shapes = (
        Shape("full_graph_sm", "train",
              dims=dict(n_nodes=120, n_edges=480, d_feat=16, n_classes=5)),
        Shape("molecule", "train",
              dims=dict(n_nodes=10 * 4, n_edges=24 * 4, d_feat=8,
                        n_classes=4, n_graphs=4)),
        Shape("minibatch_lg", "train",
              dims=dict(n_nodes=8 + 8 * 3 + 24 * 2, n_edges=8 * 3 + 24 * 2,
                        d_feat=12, n_classes=5, full_nodes=500,
                        full_edges=4000, batch_nodes=8, fanout=(3, 2))),
    )
    return dataclasses.replace(arch, arch_id=arch.arch_id + "-reduced",
                               model_cfg=small, shapes=shapes,
                               microbatches=1)


def _recsys_reduced(arch: Arch) -> Arch:
    cfg = arch.model_cfg
    small = dataclasses.replace(cfg, n_items=2000, n_cats=20, n_profiles=100,
                                seq_len=12, gru_dim=24, mlp_dims=(32, 16))
    shapes = (
        Shape("train_batch", "train", dims=dict(batch=16)),
        Shape("serve_p99", "serve", dims=dict(batch=8)),
        Shape("serve_bulk", "serve", dims=dict(batch=32)),
        Shape("retrieval_cand", "retrieval",
              dims=dict(batch=2, n_candidates=500)),
    )
    return dataclasses.replace(arch, arch_id=arch.arch_id + "-reduced",
                               model_cfg=small, shapes=shapes,
                               microbatches=2)


def reduce_arch(arch_id: str) -> Arch:
    arch = get_arch(arch_id)
    if arch.family == "gnn":
        return _gnn_reduced(arch)
    if arch.family == "recsys":
        return _recsys_reduced(arch)
    raise NotImplementedError(
        f"reduced {arch.family} configs are not ported yet (ROADMAP A10 (d))")
