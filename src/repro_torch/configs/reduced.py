"""Reduced per-arch configs (port of ``repro/configs/reduced.py``): same
family and structure, small dims, for the CPU tests, the examples and
quick runs."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import Arch, Shape, get_arch
from repro_torch.models.moe import MoEConfig


def _lm_reduced(arch: Arch) -> Arch:
    """2 layers, d_model 64, 4 heads of 16 (MHA stays MHA, GQA keeps 2 kv
    heads), vocab 512, float32; MoE capped at 8 experts, top-2, d_ff 32 an
    expert, capacity factor 2.0; the KV cache dtype kept (float8 for
    llama3 and qwen1.5); the arch's optimizer at lr 1e-3, 2 microbatches."""
    cfg = arch.model_cfg
    moe = None
    if cfg.moe is not None:
        moe = MoEConfig(num_experts=min(8, cfg.moe.num_experts),
                        top_k=min(2, cfg.moe.top_k), d_ff_expert=32,
                        capacity_factor=2.0)
    small = dataclasses.replace(
        cfg, n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=(4 if cfg.n_kv_heads == cfg.n_heads else 2),
        d_head=16, d_ff=(0 if moe else 128), vocab=512, moe=moe,
        dtype="float32", param_dtype="float32", remat=True)
    shapes = (
        Shape("train_4k", "train", dims=dict(seq_len=64, global_batch=8)),
        Shape("prefill_32k", "prefill", dims=dict(seq_len=128,
                                                  global_batch=2)),
        Shape("decode_32k", "decode", dims=dict(seq_len=128, global_batch=4)),
    )
    return dataclasses.replace(arch, arch_id=arch.arch_id + "-reduced",
                               model_cfg=small, shapes=shapes,
                               opt=dataclasses.replace(arch.opt, lr=1e-3),
                               microbatches=2)


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
    if arch.family in ("lm-dense", "lm-moe"):
        return _lm_reduced(arch)
    if arch.family == "gnn":
        return _gnn_reduced(arch)
    return _recsys_reduced(arch)
