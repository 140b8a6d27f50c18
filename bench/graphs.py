"""The benchmark's graphs, whatever generates them: the CSR as the Graph500
graphs are built, the component edge counts behind the traversal rates,
and the Graph500 root sampling.

Everything is plain torch on the run's device, from ``torch.Generator``s,
in a few large calls. Nothing here imports the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Graph(NamedTuple):
    """A CSR graph as the benchmark builds it: ``row_ptr`` int32[n + 1],
    ``col_idx`` int32[m] (each row sorted), ``src_idx`` int32[m] (the row
    of each slot), ``weights`` float32[m] or None."""
    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    src_idx: torch.Tensor
    weights: torch.Tensor | None

    @property
    def n(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def m(self) -> int:
        return self.col_idx.shape[0]

    @property
    def deg(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device``; any seed from 0 to 2**63 - 1 (larger ones
    wrap)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def build_csr(src: torch.Tensor, dst: torch.Tensor, n: int,
              w: torch.Tensor | None = None) -> Graph:
    """Symmetrise, drop self-loops, keep parallel edges, sort each row by
    neighbour (and a weighted row's parallel edges by weight), as the
    Graph500 graphs are built. ``w`` is one weight per input edge."""
    if 2 * src.numel() >= 2 ** 31:
        raise ValueError(f"{src.numel()} edges overflow an int32 CSR")
    src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * n + dst
    if w is not None:
        w = torch.cat([w, w])[keep]
        # the stable sort by key keeps the weight order within a key
        by_w = torch.sort(w, stable=True).indices
        key, src, dst, w = key[by_w], src[by_w], dst[by_w], w[by_w]
    order = torch.sort(key, stable=True).indices
    del key
    src, dst = src[order], dst[order]
    counts = torch.bincount(src, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int32, device=src.device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    return Graph(row_ptr=row_ptr, col_idx=dst.to(torch.int32),
                 src_idx=src.to(torch.int32),
                 weights=None if w is None else w[order].to(torch.float32))


def component_labels(g: Graph) -> torch.Tensor:
    """int64[n]: the least vertex id of each vertex's connected component
    (min-label propagation with pointer jumping)."""
    labels = torch.arange(g.n, dtype=torch.int64, device=g.row_ptr.device)
    src, col = g.src_idx.long(), g.col_idx.long()
    while True:
        new = labels.scatter_reduce(0, col, labels[src], "amin")
        new = new[new]
        if torch.equal(new, labels):
            return labels
        labels = new


def component_edges(g: Graph) -> np.ndarray:
    """Host int64[n]: the undirected edges of each vertex's component, the
    Graph500 count of a traversal from it (edge slots in it over 2)."""
    labels = component_labels(g)
    slots = torch.zeros(g.n, dtype=torch.int64, device=labels.device)
    slots.index_add_(0, labels, g.deg.long())
    return (slots[labels] // 2).cpu().numpy()


class RootRequests:
    """Graph500 root sampling as a request stream: each request draws ``k``
    distinct roots of degree > 0, from a host stream seeded by the run's
    seed and a salt; request i of a salt's stream holds the same roots in
    every run of that seed."""

    def __init__(self, g: Graph, k: int, seed: int):
        self.candidates = torch.nonzero(g.deg > 0).squeeze(1).cpu().numpy()
        if self.candidates.size < k:
            raise ValueError(f"{self.candidates.size} vertices of degree > 0"
                             f", fewer than {k} roots a request")
        self.k = k
        self.seed = int(seed) % (1 << 63)

    def __call__(self, salt: int):
        rng = np.random.default_rng([self.seed, salt])
        while True:
            yield rng.choice(self.candidates, self.k,
                             replace=False).astype(np.int32)
