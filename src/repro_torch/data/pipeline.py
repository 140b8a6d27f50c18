"""Synthetic but deterministic data pipelines (port of
``repro/data/pipeline.py``), the GNN family so far.

A batch is keyed by (seed, step) alone, so restoring a checkpoint restores
the exact data stream position: the kill-and-resume checks rely on it.
Batches are drawn on the device they are used on, from a ``torch.Generator``
seeded ``seed + 7919 * step`` as the reference keys its PRNG.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import Arch, Shape
from repro_torch.device import resolve_device
from repro_torch.models.gnn.common import GraphBatch, synthetic_graph_batch


def gnn_batch(arch: Arch, shape: Shape, step: int, seed: int = 0,
              device=None) -> GraphBatch:
    d = shape.dims
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed + 7919 * step)
    return synthetic_graph_batch(
        gen, d["n_nodes"], d["n_edges"], d["d_feat"],
        n_classes=d.get("n_classes", 16), n_graphs=d.get("n_graphs", 1))


def make_batch(arch: Arch, shape: Shape, step: int, seed: int = 0,
               device=None):
    if arch.family == "gnn":
        return gnn_batch(arch, shape, step, seed, device)
    raise NotImplementedError(
        f"{arch.family} batches are not ported yet (ROADMAP A10)")
