"""CSR graph containers and builders.

Layout, identical to ``repro.core.csr``:
  row_ptr : int32[n+1]   start offset of each vertex's adjacency slice
  col_idx : int32[m]     neighbour ids, sorted within each row
  src_idx : int32[m]     CSR row expansion (owner of edge slot e), for the
                         edge-parallel top-down scan and bottom-up fallback

``WeightedCSRGraph`` adds one float32 weight per edge slot (``weights[e]``
belongs to edge ``src_idx[e] -> col_idx[e]``), the substrate of the
tropical (min-plus) traversal in ``repro_torch.traversal``; symmetrised
edges carry the same weight both ways.

The graph is built on the host with numpy and moved to its device once.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


class CSRGraph(NamedTuple):
    row_ptr: torch.Tensor  # int32[n+1]
    col_idx: torch.Tensor  # int32[m]
    src_idx: torch.Tensor  # int32[m]

    @property
    def n(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def m(self) -> int:
        return self.col_idx.shape[0]

    @property
    def deg(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device


class WeightedCSRGraph(NamedTuple):
    row_ptr: torch.Tensor  # int32[n+1]
    col_idx: torch.Tensor  # int32[m]
    src_idx: torch.Tensor  # int32[m]
    weights: torch.Tensor  # float32[m], weight of edge src_idx[e]->col_idx[e]

    @property
    def n(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def m(self) -> int:
        return self.col_idx.shape[0]

    @property
    def deg(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    @property
    def csr(self) -> CSRGraph:
        """The unweighted view, which the boolean engines take."""
        return CSRGraph(row_ptr=self.row_ptr, col_idx=self.col_idx,
                        src_idx=self.src_idx)


def _build_csr(src: np.ndarray, dst: np.ndarray, n: int, symmetrize: bool,
               drop_self_loops: bool, dedup: bool, w=None):
    """Sort/symmetrize/dedup pipeline; returns numpy (row_ptr, dst, src, w).
    ``w`` is None (unweighted) or one weight per input edge, carried through
    every permutation."""
    if len(src) * (2 if symmetrize else 1) >= 2 ** 31:
        # row_ptr/col_idx are int32 and every BFS counter sums degrees in
        # int32: refuse graphs that would overflow, before any copy.
        raise ValueError(
            f"edge count {len(src)} overflows the int32 CSR/counter layout")
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if w is not None:
        w = np.asarray(w, dtype=np.float64)
        if w.shape != src.shape:
            raise ValueError(f"weights shape {w.shape} != edge count "
                             f"{src.shape}")
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if w is not None:
            w = np.concatenate([w, w])  # the reverse edge keeps its weight
    if drop_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
    key = src * n + dst
    # with weights, the secondary sort key makes dedup's keep-first rule
    # keep the minimum-weight parallel edge
    order = (np.argsort(key, kind="stable") if w is None
             else np.lexsort((w, key)))
    src, dst = src[order], dst[order]
    if w is not None:
        w = w[order]
    if dedup and len(src):
        keep = np.ones(len(src), dtype=bool)
        keep[1:] = (src[1:] != src[:-1]) | (dst[1:] != dst[:-1])
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
    counts = np.bincount(src, minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, dst, src, w


def from_numpy_graph(row_ptr: np.ndarray, col_idx: np.ndarray,
                     src_idx: np.ndarray, device=None) -> CSRGraph:
    """A ``CSRGraph`` on ``device`` from host arrays, e.g. the JAX
    package's graph as ``repro.core.csr.to_numpy_adj`` plus ``src_idx``."""
    device = resolve_device(device)

    def move(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return CSRGraph(row_ptr=move(row_ptr), col_idx=move(col_idx),
                    src_idx=move(src_idx))


def from_edges(src: np.ndarray, dst: np.ndarray, n: int,
               symmetrize: bool = True, drop_self_loops: bool = True,
               dedup: bool = False, device=None) -> CSRGraph:
    """Build a CSR graph from a directed edge list (host-side, numpy).

    Graph500 graphs are undirected: ``symmetrize`` adds the reverse edges.
    """
    device = resolve_device(device)
    row_ptr, dst, src, _ = _build_csr(src, dst, n, symmetrize,
                                      drop_self_loops, dedup)
    return from_numpy_graph(row_ptr, dst, src, device)


def from_numpy_weighted_graph(row_ptr: np.ndarray, col_idx: np.ndarray,
                              src_idx: np.ndarray, weights: np.ndarray,
                              device=None) -> WeightedCSRGraph:
    """A ``WeightedCSRGraph`` on ``device`` from host arrays, e.g. the JAX
    package's weighted graph field by field."""
    g = from_numpy_graph(row_ptr, col_idx, src_idx, device)
    w = torch.from_numpy(np.array(weights, dtype=np.float32))
    return WeightedCSRGraph(*g, weights=w.to(g.device))


def from_weighted_edges(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                        n: int, symmetrize: bool = True,
                        drop_self_loops: bool = True, dedup: bool = False,
                        device=None) -> WeightedCSRGraph:
    """``from_edges`` with one finite non-negative weight per directed
    input edge. ``symmetrize`` gives the reverse edge the same weight;
    ``dedup`` keeps the minimum-weight copy of parallel edges. NaN, +-inf
    and negative weights are refused: delta-stepping and Dijkstra need
    finite w >= 0."""
    device = resolve_device(device)
    w = np.asarray(w, dtype=np.float64)
    ok = np.isfinite(w) & (w >= 0)
    if len(w) and not ok.all():
        bad = w[~ok][0]
        raise ValueError(
            f"invalid edge weight {bad} — tropical traversal "
            f"(delta-stepping / Dijkstra) requires finite non-negative "
            f"weights")
    row_ptr, dst, src, w = _build_csr(src, dst, n, symmetrize,
                                      drop_self_loops, dedup, w)
    return from_numpy_weighted_graph(row_ptr, dst, src, w, device)


def from_edge_tensors(rows: torch.Tensor, cols: torch.Tensor,
                      mask: torch.Tensor, n: int) -> CSRGraph:
    """A CSR graph from edge tensors, built on their device: row ``rows[e]``
    holds neighbour ``cols[e]`` for every edge with ``mask[e]`` set.

    Unlike ``from_edges`` nothing goes to the host and nothing is
    symmetrised or deduplicated: direction and multi-edges are kept, and a
    stable sort by row keeps duplicate edges in their input order. The CSR
    keeps all E edge slots, so its size does not depend on the mask and no
    value is read: a masked edge is keyed to row n, which the stable sort
    puts after every live edge, so ``row_ptr[n]`` is the live count and the
    slots from it on are dead (``src_idx`` n). ``m`` counts the dead slots
    too; ``deg``, ``ell_pad`` and the aggregation kernels read only the live
    ones. The live part is what dropping the masked edges first gives."""
    key = torch.where(mask, rows.to(torch.int32), n)
    src, order = torch.sort(key, stable=True)
    col_idx = cols.to(torch.int32)[order]
    bounds = torch.arange(n + 1, dtype=torch.int32, device=src.device)
    row_ptr = torch.searchsorted(src, bounds, out_int32=True)
    return CSRGraph(row_ptr=row_ptr, col_idx=col_idx, src_idx=src)


def to_numpy_adj(g: CSRGraph) -> tuple[np.ndarray, np.ndarray]:
    """Host copies of (row_ptr, col_idx) for oracle/validator use."""
    return g.row_ptr.cpu().numpy(), g.col_idx.cpu().numpy()


def relabel(g: CSRGraph, perm: np.ndarray) -> CSRGraph:
    """Relabel vertices: new id of old vertex v is ``perm[v]``."""
    perm = np.asarray(perm)
    src = perm[g.src_idx.cpu().numpy()]
    dst = perm[g.col_idx.cpu().numpy()]
    return from_edges(src, dst, g.n, symmetrize=False, drop_self_loops=False,
                      device=g.device)


def ell_pad(g: CSRGraph, k_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """CSR rows as an ELL slab: int32[n, k_max] neighbour ids (padded with
    n) + bool[n, k_max] validity. Rows longer than k_max are truncated; the
    caller handles the residue through the edge-parallel path."""
    n, m = g.n, g.m
    pos = torch.arange(k_max, dtype=torch.int32, device=g.device)[None, :]
    valid = pos < g.deg[:, None]
    if m == 0:
        return torch.full((n, k_max), n, dtype=torch.int32,
                          device=g.device), valid
    idx = (g.row_ptr[:-1, None] + pos).clamp(0, m - 1)
    neigh = torch.where(valid, g.col_idx[idx], n)
    return neigh.to(torch.int32), valid
