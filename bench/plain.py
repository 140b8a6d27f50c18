"""The plain reference: what each cell's answers must be, in plain torch.

It reads the benchmark's own graph (``graphs.Graph``) and the roots the
benchmark drew, and works out everything else itself; it imports nothing of
the program. Each function runs on the graph's device, after the measured
window, one root or a block of lanes at a time, so that it fits beside
nothing else.

* ``bfs_depths``: a level-synchronous BFS from one root, by frontier
  expansion over the CSR rows; exact int32 depths, -1 unreached.
* ``parent_faults``: the Graph500 validation of one parent tree against the
  reference depths: each reached vertex but the root names a neighbour one
  level up, the root names itself, an unreached vertex names -1.
* ``sssp_dist``: Bellman-Ford over the active vertices, lanes in blocks;
  ``d[v] = min(d[v], d[u] + w)`` in the given dtype until nothing changes,
  which in float32 is the least fixed point that any label-correcting
  algorithm in float32 reaches, delta-stepping included.

``max_deg`` (BFS) and ``dtype`` (SSSP) are there for the controls only: the
reference computed the way a tempting shortcut would compute it (only the
first ``max_deg`` neighbours of each row, as a bottom-up probe with no
fallback; bfloat16 distances), which must come out not correct.
"""
from __future__ import annotations

import warnings

import torch

INF = float("inf")


def _expand(row_ptr: torch.Tensor, col_idx: torch.Tensor,
            rows: torch.Tensor, max_deg: int | None = None):
    """The edge slots of ``rows``: (slot's row position in ``rows``,
    neighbour id), both int64; at most ``max_deg`` slots a row."""
    starts = row_ptr[rows].long()
    deg = row_ptr[rows + 1].long() - starts
    if max_deg is not None:
        deg = deg.clamp(max=max_deg)
    total = int(deg.sum())
    pos = torch.arange(rows.numel(), device=rows.device)
    owner = torch.repeat_interleave(pos, deg, output_size=total)
    first = torch.cumsum(deg, 0) - deg
    slot = starts[owner] + torch.arange(total, device=rows.device) \
        - first[owner]
    return owner, col_idx[slot].long(), slot


def bfs_depths(row_ptr: torch.Tensor, col_idx: torch.Tensor, root: int,
               max_deg: int | None = None) -> torch.Tensor:
    """int32[n]: the BFS depth of every vertex from ``root``, -1 where
    unreached."""
    n = row_ptr.shape[0] - 1
    depth = torch.full((n,), -1, dtype=torch.int32, device=row_ptr.device)
    front = torch.tensor([int(root)], dtype=torch.int64,
                         device=row_ptr.device)
    depth[front] = 0
    d = 0
    while front.numel():
        _, nb, _ = _expand(row_ptr, col_idx, front, max_deg)
        nb = torch.unique(nb[depth[nb] < 0])
        d += 1
        depth[nb] = d
        front = nb
    return depth


def edge_keys(g) -> torch.Tensor:
    """int64[m]: ``src * n + dst`` of every slot; sorted, as the CSR rows
    are sorted by neighbour."""
    return g.src_idx.long() * g.n + g.col_idx.long()


def parent_faults(keys: torch.Tensor, n: int, root: int,
                  depth: torch.Tensor, parent: torch.Tensor) -> int:
    """How many vertices break the Graph500 parent-tree rules, given the
    reference ``depth`` int32[n] of ``root`` and a ``parent`` int[n]."""
    dev = depth.device
    parent = parent.to(dev).long()
    v = torch.arange(n, device=dev)
    reached = depth >= 0
    bad = ~reached & (parent != -1)
    inner = reached & (v != root)
    p = parent.clamp(0, n - 1)
    q = v * n + p
    at = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    linked = keys[at] == q
    ok = (parent >= 0) & (parent < n) & (depth[p] == depth - 1) & linked
    bad |= inner & ~ok
    bad[root] = bool(parent[root] != root)
    return int(bad.sum())


def sssp_dist(g, sources, dtype=torch.float32, block: int = 8) -> torch.Tensor:
    """float32[n, len(sources)]: shortest-path distances from each source
    (+inf unreached), computed in ``dtype``, ``block`` lanes at a time."""
    n = g.n
    dev = g.row_ptr.device
    sources = torch.as_tensor(sources, dtype=torch.int64, device=dev)
    w_all = g.weights.to(dtype)
    out = torch.empty((n, sources.numel()), dtype=torch.float32, device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # index_reduce_ is marked beta
        for lo in range(0, sources.numel(), block):
            src = sources[lo:lo + block]
            lanes = torch.arange(src.numel(), device=dev)
            dist = torch.full((n, src.numel()), INF, dtype=dtype, device=dev)
            dist[src, lanes] = 0
            active = torch.unique(src)
            while active.numel():
                owner, nb, slot = _expand(g.row_ptr, g.col_idx, active)
                cand = dist[active[owner]] + w_all[slot][:, None]
                new = dist.clone()
                new.index_reduce_(0, nb, cand, "amin")
                active = torch.nonzero((new < dist).any(dim=1)).squeeze(1)
                dist = new
            out[:, lo:lo + block] = dist.float()
    return out


def min_parents(g, depth: torch.Tensor, root: int) -> torch.Tensor:
    """int32[n]: each reached vertex's least neighbour one level up in
    ``depth`` (the root itself at the root, -1 where none)."""
    n = g.n
    src, col = g.src_idx.long(), g.col_idx.long()
    up = (depth[col] >= 0) & (depth[col] == depth[src] - 1)
    cand = torch.where(up, col, n)
    best = torch.full((n,), n, dtype=torch.int64, device=depth.device)
    best.scatter_reduce_(0, src, cand, "amin")
    parent = torch.where(best < n, best, -1).to(torch.int32)
    parent[root] = root
    return parent
