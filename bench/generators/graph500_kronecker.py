"""The Graph500 Kronecker (R-MAT) generator, drawn on the device; a
configuration names it as ``"generator": "graph500_kronecker"``.

The distribution is the Graph500 reference's: ``n = 2**scale`` vertices,
``m = n * edgefactor`` directed input edges, one initiator quadrant per
(edge, bit) with probabilities A/B/C/D, then a random relabelling of the
vertices and a shuffle of the edges. The graph is built by
``graphs.build_csr``: symmetrised, self-loops dropped, parallel edges kept
(no dedup), each row's neighbours sorted. A weighted graph draws one
uniform weight per input edge in ``weight_range``, the same both ways;
parallel edges keep their own weights, sorted ascending within their row.

Two seeds: the quadrant draws and the weights come from the
configuration's ``graph_seed``, the relabelling and the shuffle from the
run's seed. So every run of a configuration traverses the same graph up
to the names of its vertices, and the seed changes the inputs (the ids,
the CSR's order, the roots) but not the amount of work; a graph drawn
whole from each seed made runs of one cell differ by several per cent.
The same seeds give the same graph on a device every time (not the numpy
generator's bits).
"""
from __future__ import annotations

import torch

import graphs


def rmat_quadrants(scale: int, m: int, abcd, gen: torch.Generator,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """Directed R-MAT edges before the relabelling: int64 (src, dst).
    Bit k (most significant first) of an edge falls in quadrant 0 (0, 0)
    with probability A, 1 (0, 1) with B, 2 (1, 0) with C, 3 (1, 1) with D,
    one uniform draw per (edge, bit)."""
    a, b, c, _ = abcd
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        u = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        q = (u >= a).long() + (u >= a + b).long() + (u >= a + b + c).long()
        src = src * 2 + (q >= 2).long()
        dst = dst * 2 + (q & 1)
    return src, dst


def rmat_edges(scale: int, edgefactor: int, abcd, graph_gen: torch.Generator,
               run_gen: torch.Generator, device, weight_range=None):
    """Graph500 edges: the quadrant draw (and one weight per edge, in
    ``weight_range``) from ``graph_gen``, then a random relabelling of the
    vertices and a shuffle of the edge order from ``run_gen``. Returns
    (src, dst, n, weights or None)."""
    n = 1 << scale
    m = n * edgefactor
    src, dst = rmat_quadrants(scale, m, abcd, graph_gen, device)
    w = None
    if weight_range is not None:
        lo, hi = weight_range
        w = lo + (hi - lo) * torch.rand(m, generator=graph_gen, device=device,
                                        dtype=torch.float64)
    perm = torch.randperm(n, generator=run_gen, device=device)
    src, dst = perm[src], perm[dst]
    order = torch.randperm(m, generator=run_gen, device=device)
    return (src[order], dst[order], n,
            None if w is None else w[order])


def build(cfg: dict, seed: int, device) -> graphs.Graph:
    """The configuration's graph, relabelled by the run's seed, on
    ``device``."""
    if not (cfg["symmetrize"] and cfg["drop_self_loops"]) or cfg["dedup"]:
        raise ValueError("the Graph500 build symmetrises, drops self-loops "
                         "and keeps parallel edges")
    src, dst, n, w = rmat_edges(
        cfg["scale"], cfg["edgefactor"], cfg["abcd"],
        graphs.generator(cfg["graph_seed"], device),
        graphs.generator(seed, device), device,
        cfg["weight_range"] if cfg["weighted"] else None)
    return graphs.build_csr(src, dst, n, w)
