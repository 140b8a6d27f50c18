"""Bottom-up BFS steps: the paper's vectorised probe (BU-SIMD) and the
non-SIMD baseline (Algorithm 2).

BU-SIMD (paper §5.1, Algorithms 4-5):
  * probe phase: for pos in [0, MAX_POS) every unvisited vertex gathers its
    pos-th neighbour and tests the frontier bitmap (word = v>>5,
    bit = v&31, Listing 1); a vertex that finds a parent retires. On the GPU
    this is the ``bottom_up_probe`` CUDA kernel.
  * fallback phase: vertices with deg > MAX_POS that found nothing scan the
    rest of their row, as a masked edge-parallel scan in plain PyTorch. It
    is skipped when the probe retired everything; deciding that costs one
    host sync per bottom-up layer.

Parent selection is deterministic: col_idx is sorted within each row, so
"first hit in adjacency order" == "min frontier-neighbour id", the same
rule as the top-down scatter-min.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmap
from repro_torch.core.csr import CSRGraph
from repro_torch.kernels.bottom_up_probe.ops import bottom_up_probe

MAX_POS_DEFAULT = 8  # paper §5.2, Table 3


def _fallback_scan(g: CSRGraph, frontier_words, remaining, parent,
                   min_pos: int):
    """Edge-parallel bottom-up scan over adjacency positions >= min_pos for
    vertices in ``remaining``. First hit = min edge index (= min neighbour
    id within the row). Returns (found2, parent)."""
    n, m = g.n, g.m
    if m == 0:
        return torch.zeros_like(remaining), parent
    e = torch.arange(m, dtype=torch.int32, device=g.device)
    pos_e = e - g.row_ptr[g.src_idx]
    act = remaining[g.src_idx] & (pos_e >= min_pos) & bitmap.test(
        frontier_words, g.col_idx)
    e_cand = torch.where(act, e, m)
    e_min = torch.full((n,), m, dtype=torch.int32, device=g.device)
    e_min.scatter_reduce_(0, g.src_idx.to(torch.int64), e_cand, "amin")
    hit = e_min < m
    par_new = g.col_idx[e_min.clamp(0, m - 1)]
    return hit, torch.where(hit, par_new, parent)


def bottomup_nosimd_step(g: CSRGraph, frontier: torch.Tensor,
                         visited: torch.Tensor, parent: torch.Tensor):
    """Algorithm 2 baseline: full adjacency scan for every unvisited vertex
    (no probe phase, no bitmap retirement)."""
    remaining = ~visited
    found, parent = _fallback_scan(g, bitmap.pack(frontier), remaining,
                                   parent, 0)
    new = found & remaining
    return new, visited | new, parent


def bottomup_simd_step(g: CSRGraph, frontier: torch.Tensor,
                       visited: torch.Tensor, parent: torch.Tensor,
                       max_pos: int = MAX_POS_DEFAULT,
                       skip_empty_fallback: bool = True):
    """The paper's vectorised bottom-up (probe + conditional fallback).

    ``skip_empty_fallback=False`` always runs the fallback scan.
    """
    frontier_words = bitmap.pack(frontier)
    unvisited = ~visited
    found, parent = bottom_up_probe(g.row_ptr, g.col_idx, frontier_words,
                                    unvisited, parent, max_pos)
    remaining = unvisited & ~found & (g.deg > max_pos)
    if skip_empty_fallback and not bool(remaining.any()):
        found2 = torch.zeros_like(remaining)
    else:
        found2, parent = _fallback_scan(g, frontier_words, remaining, parent,
                                        max_pos)
    new = (found | found2) & unvisited
    return new, visited | new, parent


def bottomup_probe_stats(g: CSRGraph, frontier: torch.Tensor,
                         visited: torch.Tensor, max_pos: int):
    """Per-layer counts for the Table-3 analog: unvisited, retired by the
    probe, residue needing the fallback, probe lanes (int32 scalars)."""
    unvisited = ~visited
    parent = torch.full((g.n,), -1, dtype=torch.int32, device=g.device)
    found, _ = bottom_up_probe(g.row_ptr, g.col_idx, bitmap.pack(frontier),
                               unvisited, parent, max_pos)
    residue = unvisited & ~found & (g.deg > max_pos)
    n_unvisited = unvisited.sum().to(torch.int32)
    return dict(
        unvisited=n_unvisited,
        retired=found.sum().to(torch.int32),
        residue=residue.sum().to(torch.int32),
        probe_lanes=n_unvisited * max_pos,
    )
