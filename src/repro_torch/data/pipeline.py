"""Synthetic but deterministic data pipelines (port of
``repro/data/pipeline.py``) for the three families.

A batch is keyed by (seed, step) alone, so restoring a checkpoint restores
the exact data stream position: the kill-and-resume checks rely on it.
GNN batches are drawn on the device they are used on, from a
``torch.Generator`` seeded ``seed + 7919 * step`` as the reference keys its
PRNG. LM and recsys batches are drawn with numpy exactly as the reference
draws them (``_fold`` is its copy), so they are the reference's bits, and
moved to the device in one go.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import Arch, Shape
from repro_torch.device import resolve_device
from repro_torch.models.gnn.common import GraphBatch, synthetic_graph_batch


@dataclass
class PipelineState:
    step: int = 0


def _fold(seed: int, *vals: int) -> np.random.Generator:
    return np.random.default_rng(np.uint64(abs(hash((seed,) + vals))
                                           % (1 << 63)))


def lm_batch(arch: Arch, shape: Shape, step: int, seed: int = 0,
             device=None, host_id: int = 0, n_hosts: int = 1) -> dict:
    """The reference's numpy draw of int32 tokens [global_batch / n_hosts,
    seq_len], host ``host_id``'s rows, on ``device`` (default: the GPU);
    ``labels`` are the tokens (the loss shifts them)."""
    d = shape.dims
    rng = _fold(seed, step, host_id)
    toks = rng.integers(0, arch.model_cfg.vocab,
                        size=(d["global_batch"] // n_hosts, d["seq_len"]),
                        dtype=np.int32)
    toks = torch.from_numpy(toks).to(resolve_device(device))
    return {"tokens": toks, "labels": toks}


def gnn_batch(arch: Arch, shape: Shape, step: int, seed: int = 0,
              device=None) -> GraphBatch:
    d = shape.dims
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed + 7919 * step)
    return synthetic_graph_batch(
        gen, d["n_nodes"], d["n_edges"], d["d_feat"],
        n_classes=d.get("n_classes", 16), n_graphs=d.get("n_graphs", 1))


def recsys_batch(arch: Arch, shape: Shape, step: int, seed: int = 0,
                 device=None, host_id: int = 0, n_hosts: int = 1) -> dict:
    """The reference's numpy draws of host ``host_id``'s batch / n_hosts
    rows, in its order, moved to ``device`` (default: the GPU)."""
    device = resolve_device(device)
    cfg = arch.model_cfg
    b = shape.dims["batch"] // n_hosts
    t, m = cfg.seq_len, cfg.profile_bag
    rng = _fold(seed, step, host_id)
    batch = {
        "target_item": rng.integers(0, cfg.n_items, b, dtype=np.int32),
        "target_cat": rng.integers(0, cfg.n_cats, b, dtype=np.int32),
        "hist_items": rng.integers(0, cfg.n_items, (b, t), dtype=np.int32),
        "hist_cats": rng.integers(0, cfg.n_cats, (b, t), dtype=np.int32),
        "hist_mask": rng.random((b, t)) < 0.9,
        "profile_ids": rng.integers(0, cfg.n_profiles, (b, m), dtype=np.int32),
        "profile_mask": np.ones((b, m), bool),
    }
    if shape.kind == "train":
        batch["labels"] = (rng.random(b).astype(np.float32)
                           < 0.5).astype(np.float32)
        batch["neg_items"] = rng.integers(0, cfg.n_items, (b, t),
                                          dtype=np.int32)
    if shape.kind == "retrieval":
        batch["candidate_ids"] = np.arange(shape.dims["n_candidates"],
                                           dtype=np.int32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def make_batch(arch: Arch, shape: Shape, step: int, seed: int = 0,
               device=None, host_id: int = 0, n_hosts: int = 1):
    """The step's batch, or host ``host_id``'s part of it of ``n_hosts``
    (LM and recsys: each host draws its own rows, keyed by (seed, step,
    host), so a host-to-slice assignment can be permuted without changing
    the global batch; a GNN batch is whole)."""
    if arch.family in ("lm-dense", "lm-moe"):
        return lm_batch(arch, shape, step, seed, device, host_id, n_hosts)
    if arch.family == "gnn":
        return gnn_batch(arch, shape, step, seed, device)
    return recsys_batch(arch, shape, step, seed, device, host_id, n_hosts)
