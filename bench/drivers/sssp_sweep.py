"""Driver of the SSSP sweep cells: one request is one batch of sources
through the analytics engine's ``LaneEngine.sssp_sweep`` on the engine's
defaults (its lane pool, delta-stepping at its default bucket width), in a
closed loop with one client.

Traffic keys: ``roots_per_request`` (fresh sources of degree > 0). A
request's work is the Graph500 edge count of its traversals, as in
``bfs_sweep``.

The check compares every sampled request's distances with the plain
Bellman-Ford reference in float32, the precision the configuration
states, by one number: the largest relative difference of a distance. A
vertex reached on one side only, or a lane that the engine flushed at its
step cap (``truncated``: its distances are partial), reads ``FAR``.
"""
from __future__ import annotations

import torch

import faults as planted
import graphs
import loops
import plain

# both sides add d[u] + w in float32 and take exact minima, so equal
# arithmetic gives equal bits: sound runs read 0 and the bfloat16 control
# 0.028-0.036 (PERF.md); the limit leaves about 170 float32 ulps (2**-24
# each) above the one and lies 2,800 times below the other
DIST_REL_LIMIT = 1e-5
# the reading of a reached-set mismatch or a truncated lane
FAR = 1e30
SSSP = "repro_torch.traversal.sssp"


class Program:
    """The system under test, built on the benchmark's graph, and the loop
    that drives it."""

    def __init__(self, graph, traffic, seed, device):
        from repro_torch.analytics.engine import LaneEngine
        from repro_torch.core.csr import WeightedCSRGraph
        self.device = device
        self.requests = requests(graph, traffic, seed)
        self.edges = graphs.component_edges(graph)
        self.engine = LaneEngine(WeightedCSRGraph(row_ptr=graph.row_ptr,
                                                  col_idx=graph.col_idx,
                                                  src_idx=graph.src_idx,
                                                  weights=graph.weights))

    def serve(self, sources):
        return self.engine.sssp_sweep(sources)

    @staticmethod
    def keep(result):
        return {"dist": result.dist, "truncated": result.truncated}

    def loop(self, salt):
        return loops.closed_loop(
            self.serve, self.requests(salt), self.device,
            lambda roots: {"edges": int(self.edges[roots].sum())}, self.keep)


def requests(graph, traffic, seed):
    """The request stream, as the program's loop draws it: ``(salt)`` ->
    each request's sources."""
    return graphs.RootRequests(graph, traffic["roots_per_request"], seed)


def compare(ref: torch.Tensor, got: torch.Tensor) -> float:
    """The largest relative difference of one request's [n, R] distances;
    ``FAR`` where a vertex is reached on one side only. A distance of 0 (a
    source) must be met exactly: its difference over the floor 1e-30
    reads far above any limit."""
    got = got.to(ref.device)
    fin = torch.isfinite(ref)
    if not torch.equal(fin, torch.isfinite(got)):
        return FAR
    rel = (got[fin] - ref[fin]).abs() / ref[fin].clamp(min=1e-30)
    return float(rel.max()) if rel.numel() else 0.0


def check(graph, samples, traffic):
    worst, failed = 0.0, 0
    for roots, kept in samples:
        err = compare(plain.sssp_dist(graph, roots), kept["dist"])
        if bool(kept["truncated"].any()):
            err = FAR
        worst = max(worst, err)
        failed += err > DIST_REL_LIMIT
    return {"dist_rel_err": (worst, DIST_REL_LIMIT)}, failed


def control(graph, roots, traffic):
    """The control: the plain reference in the program's place, computed in
    bfloat16, the precision below the configuration's float32. Must not be
    correct."""
    return {"dist": plain.sssp_dist(graph, roots, dtype=torch.bfloat16),
            "truncated": torch.zeros(len(roots), dtype=torch.bool)}


def _dist_altered(res):
    d = res.dist.clone()
    v = int(torch.nonzero(torch.isfinite(d[:, 0]) & (d[:, 0] > 0))[0])
    d[v, 0] *= 1 + 2 ** -10
    return res._replace(dist=d)


def faults(traffic) -> dict:
    """The faults a cell of this driver can have: {name: (target, make)}."""
    return {
        "drain returns its state unchanged":
            (f"{SSSP}:sssp_engine_drain", planted.unchanged),
        "half of the batch left out":
            ("repro_torch.analytics.engine:LaneEngine.sssp_sweep",
             planted.half_batch),
        "a distance altered":
            (f"{SSSP}:sssp_engine_result", planted.altered(_dist_altered)),
    }
