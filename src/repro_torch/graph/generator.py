"""Graph500 Kronecker (R-MAT) graph generator.

Follows the Graph500 reference spec: ``n = 2**scale`` vertices,
``m = 2**scale * edgefactor`` undirected edges, initiator probabilities
A=0.57, B=0.19, C=0.19, D=0.05, followed by a random vertex relabelling and
edge-order shuffle.

The sampling is numpy ``default_rng`` code copied from
``repro.graph.generator``, so a seed gives the same edges, bit for bit, in
both packages; so are the weighted graphs' uniform (0, 1) edge weights,
drawn from their own seed stream. Edges are drawn on the host; the CSR goes
to the device once.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import (CSRGraph, WeightedCSRGraph, from_edges,
                                  from_weighted_edges)
from repro_torch.device import resolve_device

GRAPH500_ABCD = (0.57, 0.19, 0.19, 0.05)

# Graph500 SSSP-kernel convention: uniform edge weights in (0, 1]
WEIGHT_RANGE = (0.0, 1.0)


def rmat_edges(scale: int, edgefactor: int, seed: int = 0,
               abcd: tuple[float, float, float, float] = GRAPH500_ABCD,
               ) -> tuple[np.ndarray, np.ndarray, int]:
    """Sample directed R-MAT edges; returns (src, dst, n)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edgefactor
    a, b, c, d = abcd
    # Quadrant per (edge, bit): 0->(0,0) w.p. A, 1->(0,1) B, 2->(1,0) C, 3->(1,1) D
    u = rng.random((m, scale))
    q = np.zeros((m, scale), dtype=np.int8)
    q += (u >= a).astype(np.int8)
    q += (u >= a + b).astype(np.int8)
    q += (u >= a + b + c).astype(np.int8)
    src_bits = (q >= 2).astype(np.int64)
    dst_bits = (q & 1).astype(np.int64)
    weights = 1 << np.arange(scale - 1, -1, -1, dtype=np.int64)
    src = src_bits @ weights
    dst = dst_bits @ weights
    # Graph500: random relabelling + edge shuffle
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    order = rng.permutation(m)
    return src[order], dst[order], n


def rmat_graph(scale: int, edgefactor: int, seed: int = 0,
               abcd: tuple[float, float, float, float] = GRAPH500_ABCD,
               device=None) -> CSRGraph:
    """Generate a symmetrised CSR Graph500 graph on ``device``."""
    device = resolve_device(device)
    src, dst, n = rmat_edges(scale, edgefactor, seed, abcd)
    return from_edges(src, dst, n, symmetrize=True, drop_self_loops=True,
                      device=device)


def edge_weights(m: int, seed: int = 0,
                 weight_range: tuple[float, float] = WEIGHT_RANGE,
                 ) -> np.ndarray:
    """One uniform weight per directed input edge, float64[m], from a seed
    stream independent of the edge sampler's, so (scale, seed) still pins
    the unweighted topology."""
    lo, hi = weight_range
    if not 0 <= lo <= hi:
        raise ValueError(f"need 0 <= lo <= hi, got weight_range "
                         f"({lo}, {hi})")
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x5557]))
    return rng.uniform(lo, hi, size=m)


def rmat_weighted_graph(scale: int, edgefactor: int, seed: int = 0,
                        abcd: tuple[float, float, float, float]
                        = GRAPH500_ABCD,
                        weight_range: tuple[float, float] = WEIGHT_RANGE,
                        device=None) -> WeightedCSRGraph:
    """``rmat_graph`` with one uniform weight per undirected edge, the same
    both ways; its ``.csr`` equals ``rmat_graph(scale, edgefactor, seed)``."""
    device = resolve_device(device)
    src, dst, n = rmat_edges(scale, edgefactor, seed, abcd)
    w = edge_weights(len(src), seed, weight_range)
    return from_weighted_edges(src, dst, w, n, symmetrize=True,
                               drop_self_loops=True, device=device)


def uniform_random_weighted_graph(n: int, m: int, seed: int = 0,
                                  weight_range: tuple[float, float]
                                  = WEIGHT_RANGE,
                                  device=None) -> WeightedCSRGraph:
    """Weighted G(n, m) graph, used by the SSSP tests."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    w = edge_weights(m, seed, weight_range)
    return from_weighted_edges(src, dst, w, n, symmetrize=True,
                               drop_self_loops=True, device=device)


def uniform_random_graph(n: int, m: int, seed: int = 0,
                         device=None) -> CSRGraph:
    """Erdős–Rényi-ish G(n, m) graph, used by the property tests."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return from_edges(src, dst, n, symmetrize=True, drop_self_loops=True,
                      device=device)


def sample_roots(g: CSRGraph, num: int, seed: int = 1,
                 require_edges: bool = True) -> np.ndarray:
    """Graph500 root sampling: ``num`` distinct roots; roots with degree 0
    are excluded when ``require_edges`` (they'd traverse 0 edges)."""
    rng = np.random.default_rng(seed)
    deg = g.deg.cpu().numpy()
    candidates = np.flatnonzero(deg > 0) if require_edges else np.arange(g.n)
    num = min(num, len(candidates))
    return rng.choice(candidates, size=num, replace=False)
