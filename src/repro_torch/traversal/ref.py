"""Host-side numpy oracles for the weighted traversal (the port's own copy
of ``repro.traversal.ref``)."""
from __future__ import annotations

import heapq

import numpy as np


def dijkstra_reference(row_ptr: np.ndarray, col_idx: np.ndarray,
                       weights: np.ndarray, root: int) -> np.ndarray:
    """Binary-heap Dijkstra over a host CSR copy. Returns float64[n]
    distances with inf unreached; handles parallel edges, zero weights and
    disconnected graphs (weights must be non-negative)."""
    n = len(row_ptr) - 1
    dist = np.full(n, np.inf)
    dist[root] = 0.0
    heap = [(0.0, root)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue                   # stale entry
        for e in range(row_ptr[u], row_ptr[u + 1]):
            v = col_idx[e]
            nd = d + weights[e]
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


def to_numpy_weighted(wg) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host copies of (row_ptr, col_idx, weights) for oracle use."""
    return (wg.row_ptr.cpu().numpy(), wg.col_idx.cpu().numpy(),
            wg.weights.cpu().numpy())
