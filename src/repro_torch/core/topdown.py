"""Edge-parallel top-down BFS step (the TD-SIMD analog).

Every edge slot is one lane; lanes whose source is in the frontier and whose
destination is unvisited propose their source as parent, and each
destination keeps the minimum. The deterministic min-parent rule makes
top-down, bottom-up and the oracle produce identical trees.

``topdown_step`` runs the fused ``topdown_scan`` kernel on the GPU (scan and
scatter-min over the frontier rows' slots only). ``topdown_ell_step`` and
``topdown_active_lanes`` are plain PyTorch, as their references are plain
XLA.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmap
from repro_torch.core.csr import CSRGraph
from repro_torch.kernels.topdown_scan.ops import topdown_scan


def topdown_step(g: CSRGraph, frontier: torch.Tensor, visited: torch.Tensor,
                 parent: torch.Tensor):
    """One top-down layer.

    Args:
      frontier: bool[n], the current layer.
      visited:  bool[n], includes the frontier.
      parent:   int32[n].
    Returns (new_frontier, visited, parent).
    """
    n = g.n
    best = topdown_scan(g.row_ptr, g.col_idx, bitmap.pack(frontier),
                        bitmap.pack(visited), n)
    new = (best < n) & ~visited
    parent = torch.where(new, best, parent)
    return new, visited | new, parent


def topdown_active_lanes(g: CSRGraph, frontier: torch.Tensor) -> torch.Tensor:
    """e_f: number of edge lanes active this layer (the paper's 'edges to
    check in the frontier' counter)."""
    return torch.where(frontier, g.deg, 0).sum().to(torch.int32)


def topdown_ell_step(g: CSRGraph, ell, frontier: torch.Tensor,
                     visited: torch.Tensor, parent: torch.Tensor,
                     k_max: int = 16):
    """Beyond-paper: scan only the first ``k_max`` adjacency slots of every
    vertex (ELL slab from ``ell_pad``), masked by frontier membership, and
    fall back to the masked edge-parallel scan only for frontier vertices
    with deg > k_max. Skipping the residue costs one host sync."""
    n = g.n
    neigh, valid = ell
    act = valid & frontier[:, None]
    src = torch.arange(n, dtype=torch.int32, device=g.device)[:, None]
    cand = torch.where(act, src, n).to(torch.int32)
    best = torch.full((n,), n, dtype=torch.int32, device=g.device)
    best.scatter_reduce_(0, neigh.clamp(0, n - 1).reshape(-1).to(torch.int64),
                         cand.reshape(-1), "amin")
    if bool((frontier & (g.deg > k_max)).any()):
        e = torch.arange(g.m, dtype=torch.int32, device=g.device)
        pos_e = e - g.row_ptr[g.src_idx]
        act_e = frontier[g.src_idx] & (pos_e >= k_max)
        cand_e = torch.where(act_e, g.src_idx, n).to(torch.int32)
        best.scatter_reduce_(0, g.col_idx.to(torch.int64), cand_e, "amin")
    new = (best < n) & ~visited
    parent = torch.where(new, best, parent)
    return new, visited | new, parent
