"""Reference BFS oracles (host-side numpy), independent of the BFS steps.

A copy of ``repro.core.ref``, kept here so that the port imports nothing of
the JAX package:
  * ``bfs_reference``: level-synchronous numpy BFS with the same
    deterministic min-parent rule as the BFS steps, so exact array equality
    holds;
  * ``bfs_queue``: classic deque BFS, for depth ground truth only.
"""
from __future__ import annotations

from collections import deque

import numpy as np


def bfs_reference(row_ptr: np.ndarray, col_idx: np.ndarray, root: int):
    """Level-synchronous BFS; parent[v] = min-id frontier neighbour of v.

    Returns (parent, depth) int32 arrays (-1 for unreached; parent[root]=root).
    """
    n = len(row_ptr) - 1
    src = np.repeat(np.arange(n), np.diff(row_ptr))
    dst = np.asarray(col_idx)
    parent = np.full(n, -1, np.int32)
    depth = np.full(n, -1, np.int32)
    parent[root] = root
    depth[root] = 0
    frontier = np.zeros(n, bool)
    visited = np.zeros(n, bool)
    frontier[root] = visited[root] = True
    layer = 0
    while frontier.any():
        active = frontier[src] & ~visited[dst]
        cand = np.full(n, n, np.int64)
        np.minimum.at(cand, dst[active], src[active])
        new = (cand < n) & ~visited
        parent[new] = cand[new]
        depth[new] = layer + 1
        visited |= new
        frontier = new
        layer += 1
    return parent, depth


def bfs_queue(row_ptr: np.ndarray, col_idx: np.ndarray, root: int):
    """Deque BFS for independent depth ground truth."""
    n = len(row_ptr) - 1
    depth = np.full(n, -1, np.int32)
    depth[root] = 0
    q = deque([root])
    while q:
        u = q.popleft()
        for v in col_idx[row_ptr[u]:row_ptr[u + 1]]:
            if depth[v] < 0:
                depth[v] = depth[u] + 1
                q.append(v)
    return depth
