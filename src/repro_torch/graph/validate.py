"""Graph500 BFS-tree validator (spec section 4 of the Graph500 benchmark).

A copy of ``repro.graph.validate``, kept here so that the port imports
nothing of the JAX package.

Host-side numpy; rules:
  1. parent[root] == root and depth[root] == 0;
  2. every reached vertex chains to the root through parent pointers with no
     cycles, and tree edges exist in the graph;
  3. tree-edge endpoints differ by exactly one BFS level;
  4. every graph edge between reached vertices spans <= 1 level;
  5. the reached set is closed under graph edges (=> it is exactly the
     connected component of the root).
"""
from __future__ import annotations

import numpy as np


class ValidationError(AssertionError):
    pass


# Largest n for which the dense key src*n+dst stays inside int64:
# max key is n*n - 1, so n <= floor(sqrt(2**63 - 1)). Beyond that the key
# multiplication wraps SILENTLY (numpy int64 overflow) and membership
# tests return garbage — fuzzed/synthetic graphs with huge sparse id
# spaces must take the per-row bisect path instead.
_DENSE_KEY_N_MAX = 3_037_000_499


def _edges_exist_dense_key(row_ptr, col_idx, u, v) -> np.ndarray:
    """CSR rows are sorted by neighbour id, so the global key src*n+dst is
    globally sorted -> one searchsorted answers all queries. Only valid
    for n <= _DENSE_KEY_N_MAX (key must fit int64)."""
    n = len(row_ptr) - 1
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    keys = src * n + col_idx.astype(np.int64)
    q = u.astype(np.int64) * n + v.astype(np.int64)
    pos = np.searchsorted(keys, q)
    pos = np.clip(pos, 0, len(keys) - 1)
    return keys[pos] == q


def _edges_exist_bisect(row_ptr, col_idx, u, v) -> np.ndarray:
    """Overflow-safe membership: vectorised lower_bound of v[i] within
    row u[i]'s sorted adjacency slice — no n-dependent key arithmetic."""
    m = len(col_idx)
    if m == 0:
        return np.zeros(len(u), dtype=bool)
    lo = row_ptr[u].astype(np.int64)
    end = row_ptr[u.astype(np.int64) + 1].astype(np.int64)
    hi = end.copy()
    v64 = v.astype(np.int64)
    while True:
        live = lo < hi
        if not live.any():
            break
        mid = (lo + hi) >> 1
        midv = col_idx[np.clip(mid, 0, max(m - 1, 0))].astype(np.int64)
        go_right = live & (midv < v64)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(live & ~go_right, mid, hi)
    return (lo < end) & (col_idx[np.clip(lo, 0, max(m - 1, 0))] == v64)


def _edges_exist(row_ptr, col_idx, u, v) -> np.ndarray:
    """Vectorised membership test: is v[i] in adj(u[i])?"""
    n = len(row_ptr) - 1
    if n <= _DENSE_KEY_N_MAX:
        return _edges_exist_dense_key(row_ptr, col_idx, u, v)
    return _edges_exist_bisect(row_ptr, col_idx, u, v)


def depths_from_parents(parent: np.ndarray, root: int,
                        max_depth: int = 64) -> np.ndarray:
    """Depth of every reached vertex via pointer doubling; raises on cycles
    or chains that do not reach the root within ``max_depth`` levels."""
    parent = np.asarray(parent)
    n = len(parent)
    reached = parent >= 0
    ptr = np.where(reached, parent, root).astype(np.int64)
    ptr[root] = root
    dist = np.where(reached, 1, 0).astype(np.int64)
    dist[root] = 0
    rounds = 0
    while True:
        live = reached & (ptr != root)
        if not live.any():
            break
        rounds += 1
        if (1 << rounds) > 4 * max_depth:
            raise ValidationError("rule 2: parent pointers do not reach root")
        dist = dist + np.where(live, dist[ptr], 0)
        ptr = np.where(live, ptr[ptr], ptr)
    return np.where(reached, dist, -1).astype(np.int64)


def validate_bfs_tree(row_ptr: np.ndarray, col_idx: np.ndarray,
                      parent: np.ndarray, root: int) -> dict:
    row_ptr = np.asarray(row_ptr)
    col_idx = np.asarray(col_idx)
    parent = np.asarray(parent)
    n = len(row_ptr) - 1
    reached = parent >= 0

    if not reached[root] or parent[root] != root:
        raise ValidationError("rule 1: root not its own parent")

    depth = depths_from_parents(parent, root)

    tree_v = np.flatnonzero(reached & (np.arange(n) != root))
    if len(tree_v):
        tree_p = parent[tree_v]
        if not reached[tree_p].all():
            raise ValidationError("rule 2: parent of reached vertex unreached")
        if not _edges_exist(row_ptr, col_idx, tree_v, tree_p).all():
            raise ValidationError("rule 2: tree edge missing from graph")
        if not (depth[tree_v] == depth[tree_p] + 1).all():
            raise ValidationError("rule 3: tree edge does not span one level")

    src = np.repeat(np.arange(n), np.diff(row_ptr))
    dst = col_idx
    if (reached[src] & ~reached[dst]).any():
        raise ValidationError("rule 5: reached set not edge-closed")
    both = reached[src] & reached[dst]
    if both.any() and np.abs(depth[src[both]] - depth[dst[both]]).max() > 1:
        raise ValidationError("rule 4: graph edge spans >1 level")

    return {"n_reached": int(reached.sum()), "max_depth": int(depth.max())}
