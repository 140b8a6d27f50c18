"""Driver of the BFS sweep cells: one request is one batch of roots through
the analytics engine's ``LaneEngine.sweep``, depths only or with the
Graph500 parent trees, in a closed loop with one client.

Traffic keys: ``roots_per_request`` (fresh roots of degree > 0, Graph500's
sampling), ``lanes`` (the engine's bit-lane pool; null = the adaptive
pool, the analytics default), ``derive_parents``. A request's work is the
Graph500 edge count of its traversals: the undirected edges of each root's
component, counted by the benchmark's own plain code.

The check compares every sampled request's depths with the plain BFS from
each of its roots (all vertices, all lanes), and in a parents cell
validates each parent tree against those depths by the Graph500 rules. Both
are exact: a count of vertices that differ, limit 0.
"""
from __future__ import annotations

import torch

import faults as planted
import graphs
import loops
import plain

# exact comparisons, counted in vertex-lanes: any vertex at another depth,
# or with a parent that is not a neighbour one level up, is a wrong answer.
# Sound runs read 0; the control (each row's first 8 neighbours only) reads
# about 1.2e8 to 1.7e8 of each (PERF.md)
DEPTH_LIMIT = 0
PARENT_LIMIT = 0
MSBFS = "repro_torch.core.msbfs"


class Program:
    """The system under test, built on the benchmark's graph, and the loop
    that drives it."""

    def __init__(self, graph, traffic, seed, device):
        from repro_torch.analytics.engine import LaneEngine
        from repro_torch.core.csr import CSRGraph
        self.device = device
        self.requests = requests(graph, traffic, seed)
        self.edges = graphs.component_edges(graph)
        self.parents = traffic["derive_parents"]
        self.engine = LaneEngine(CSRGraph(row_ptr=graph.row_ptr,
                                          col_idx=graph.col_idx,
                                          src_idx=graph.src_idx),
                                 lanes=traffic["lanes"])

    def serve(self, roots):
        return self.engine.sweep(roots, derive_parents=self.parents)

    def keep(self, result):
        kept = {"depth": result.depth}
        if self.parents:
            kept["parent"] = result.parent
        return kept

    def loop(self, salt):
        return loops.closed_loop(
            self.serve, self.requests(salt), self.device,
            lambda roots: {"edges": int(self.edges[roots].sum())}, self.keep)


def compare(graph, roots, kept, want_parents, keys=None):
    """(vertices at another depth, parent-rule faults) of one request."""
    depth_mis = parent_bad = 0
    for lane, r in enumerate(roots):
        ref = plain.bfs_depths(graph.row_ptr, graph.col_idx, int(r))
        got = kept["depth"][:, lane].to(ref.device)
        depth_mis += int((got != ref).sum())
        if want_parents:
            parent_bad += plain.parent_faults(keys, graph.n, int(r), ref,
                                              kept["parent"][:, lane])
    return depth_mis, parent_bad


def check(graph, samples, traffic):
    want_parents = traffic["derive_parents"]
    keys = plain.edge_keys(graph) if want_parents else None
    depth_mis = parent_bad = failed = 0
    for roots, kept in samples:
        d, p = compare(graph, roots, kept, want_parents, keys)
        depth_mis += d
        parent_bad += p
        failed += (d + p) > 0
    checks = {"depth_mismatch": (depth_mis, DEPTH_LIMIT)}
    if want_parents:
        checks["parent_faults"] = (parent_bad, PARENT_LIMIT)
    return checks, failed


def control(graph, roots, traffic, max_deg: int = 8):
    """The control: the plain reference in the program's place, computed
    the tempting wrong way, over each row's first ``max_deg`` neighbours
    only (a bounded bottom-up probe with no fallback), with parents as the
    least neighbour one level up in those depths. Must not be correct."""
    depth = torch.stack([plain.bfs_depths(graph.row_ptr, graph.col_idx,
                                          int(r), max_deg) for r in roots],
                        dim=1)
    kept = {"depth": depth}
    if traffic["derive_parents"]:
        kept["parent"] = torch.stack(
            [plain.min_parents(graph, depth[:, i], int(r))
             for i, r in enumerate(roots)], dim=1)
    return kept


def _depth_altered(res):
    d = res.depth.clone()
    v = int(torch.nonzero(d[:, 0] > 0)[0])
    d[v, 0] += 1
    return res._replace(depth=d)


def _parent_altered(res):
    p = res.parent.clone()
    v = int(torch.nonzero(res.depth[:, 0] > 0)[0])
    p[v, 0] = v
    return res._replace(parent=p)


def requests(graph, traffic, seed):
    """The request stream, as the program's loop draws it: ``(salt)`` ->
    each request's roots."""
    return graphs.RootRequests(graph, traffic["roots_per_request"], seed)


def faults(traffic) -> dict:
    """The faults a cell of this driver can have: {name: (target, make)}."""
    out = {
        "drain returns its state unchanged":
            (f"{MSBFS}:msbfs_engine_drain", planted.unchanged),
        "half of the batch left out":
            ("repro_torch.analytics.engine:LaneEngine.sweep",
             planted.half_batch),
        "a depth altered":
            (f"{MSBFS}:msbfs_engine_result", planted.altered(_depth_altered)),
    }
    if traffic["derive_parents"]:
        out["a parent altered"] = (f"{MSBFS}:msbfs_engine_result",
                                   planted.altered(_parent_altered))
    return out
