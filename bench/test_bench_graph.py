"""CPU tests of the benchmark's yardstick: the device R-MAT generator and its
CSR, the component edge count behind the traversal rates, the plain
references and the kernels' cost functions."""
import heapq
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import costs  # noqa: E402
import graphs  # noqa: E402
import harness  # noqa: E402
import plain  # noqa: E402

kron = harness.load_module(BENCH / "generators" / "graph500_kronecker.py",
                           "bench_generators")

ABCD = (0.57, 0.19, 0.19, 0.05)
CPU = torch.device("cpu")


def graph_of(edges, n, weights=None):
    src = torch.tensor([a for a, _ in edges], dtype=torch.int64)
    dst = torch.tensor([b for _, b in edges], dtype=torch.int64)
    w = None if weights is None else torch.tensor(weights,
                                                  dtype=torch.float64)
    return graphs.build_csr(src, dst, n, w)


def test_quadrant_frequencies():
    scale, m = 10, 1 << 15
    src, dst = kron.rmat_quadrants(scale, m, ABCD, graphs.generator(5, CPU),
                                   CPU)
    for k in range(scale):
        s, d = (src >> k) & 1, (dst >> k) & 1
        freq = [float(((s == a) & (d == b)).double().mean())
                for a, b in ((0, 0), (0, 1), (1, 0), (1, 1))]
        # m draws a bit: the standard error of a share near 0.57 is 0.003
        assert np.allclose(freq, ABCD, atol=0.015), (k, freq)


@pytest.mark.parametrize("weighted", [False, True])
def test_csr_matches_the_ports_builder(weighted):
    from repro_torch.core.csr import _build_csr
    src, dst, n, w = kron.rmat_edges(
        8, 16, ABCD, graphs.generator(5, CPU), graphs.generator(2 ** 31 + 11, CPU),
        CPU, (0.0, 1.0) if weighted else None)
    g = graphs.build_csr(src, dst, n, w)
    row_ptr, col, srt, ww = _build_csr(
        src.numpy(), dst.numpy(), n, symmetrize=True, drop_self_loops=True,
        dedup=False, w=None if w is None else w.numpy())
    assert np.array_equal(g.row_ptr.numpy(), row_ptr)
    assert np.array_equal(g.col_idx.numpy(), col)
    assert np.array_equal(g.src_idx.numpy(), srt)
    if weighted:
        assert np.array_equal(g.weights.numpy(), ww.astype(np.float32))


def test_the_seed_relabels_one_graph():
    cfg = dict(generator="graph500_kronecker", scale=7, edgefactor=8,
               abcd=list(ABCD), weighted=True, weight_range=[0.0, 1.0],
               graph_seed=1, symmetrize=True, drop_self_loops=True,
               dedup=False)
    a, b, c = (kron.build(cfg, s, CPU) for s in (3, 3, 4))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.col_idx, c.col_idx)
    assert a.m > 0 and bool((a.col_idx != a.src_idx).all())
    # the same graph under other vertex names: the same degrees, weights and
    # component sizes
    for f in (lambda g: g.deg, lambda g: g.weights,
              lambda g: torch.from_numpy(graphs.component_edges(g))):
        assert torch.equal(torch.sort(f(a)).values, torch.sort(f(c)).values)
    other = kron.build(dict(cfg, graph_seed=2), 3, CPU)
    assert not torch.equal(torch.sort(a.weights).values,
                           torch.sort(other.weights).values)


def test_component_edges_and_roots():
    # a triangle with a doubled edge, a path of two edges, an isolated vertex
    g = graph_of([(0, 1), (1, 2), (2, 0), (0, 1), (3, 4), (4, 5)], 7)
    assert graphs.component_edges(g).tolist() == [4, 4, 4, 2, 2, 2, 0]
    stream = graphs.RootRequests(g, 3, 9)(1)
    roots = [next(stream) for _ in range(4)]
    again = graphs.RootRequests(g, 3, 9)(1)
    assert all(np.array_equal(r, next(again)) for r in roots)
    assert not np.array_equal(roots[0], next(graphs.RootRequests(g, 3, 9)(2)))
    for r in roots:
        assert len(set(r.tolist())) == 3 and 6 not in r


def test_component_edges_match_the_ports_traversal():
    from repro_torch.core.csr import CSRGraph
    from repro_torch.core.msbfs import msbfs_pipelined
    cfg = dict(generator="graph500_kronecker", scale=8, edgefactor=4,
               abcd=list(ABCD), weighted=False, graph_seed=1,
               symmetrize=True, drop_self_loops=True, dedup=False)
    g = kron.build(cfg, 21, CPU)
    roots = next(graphs.RootRequests(g, 16, 21)(2))
    res = msbfs_pipelined(CSRGraph(g.row_ptr, g.col_idx, g.src_idx), roots)
    assert np.array_equal(res.edges_traversed.numpy() // 2,
                          graphs.component_edges(g)[roots])


def test_bfs_depths_and_parent_rules():
    # 0 - 1 - 2 - 3 and 0 - 4 - 3; 5 - 6 apart
    g = graph_of([(0, 1), (1, 2), (2, 3), (0, 4), (4, 3), (5, 6)], 7)
    depth = plain.bfs_depths(g.row_ptr, g.col_idx, 0)
    assert depth.tolist() == [0, 1, 2, 2, 1, -1, -1]
    keys = plain.edge_keys(g)
    good = plain.min_parents(g, depth, 0)
    assert good.tolist() == [0, 0, 1, 4, 0, -1, -1]
    assert plain.parent_faults(keys, 7, 0, depth, good) == 0
    for v, p in ((3, 1), (2, 3), (5, 6), (0, 1), (1, 9)):
        bad = good.clone()
        bad[v] = p
        assert plain.parent_faults(keys, 7, 0, depth, bad) == 1, (v, p)
    # the control's truncated rows: only the first neighbour of each row
    assert plain.bfs_depths(g.row_ptr, g.col_idx, 0, 1).tolist() == \
        [0, 1, -1, -1, -1, -1, -1]


def dijkstra(n, edges, weights, s):
    adj = [[] for _ in range(n)]
    for (a, b), w in zip(edges, weights):
        if a != b:
            adj[a].append((b, np.float32(w)))
            adj[b].append((a, np.float32(w)))
    dist = [np.float32(np.inf)] * n
    dist[s] = np.float32(0)
    heap = [(0.0, s)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for v, w in adj[u]:
            nd = np.float32(dist[u] + w)
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (float(nd), v))
    return np.array(dist, np.float32)


def test_sssp_reference_and_its_control():
    rng = np.random.default_rng(3)
    n = 40
    edges = [tuple(e) for e in rng.integers(0, n, (120, 2))]
    weights = rng.uniform(0, 1, 120)
    g = graph_of(edges, n, weights)
    got = plain.sssp_dist(g, [0, 5, 17], block=2)
    for lane, s in enumerate((0, 5, 17)):
        assert np.array_equal(got[:, lane].numpy(),
                              dijkstra(n, edges, weights, s))
    low = plain.sssp_dist(g, [0, 5, 17], dtype=torch.bfloat16)
    fin = torch.isfinite(got) & (got > 0)
    assert torch.equal(torch.isfinite(low), torch.isfinite(got))
    assert float(((low - got).abs()[fin] / got[fin]).max()) > 1e-4


def test_cost_functions_on_a_hand_graph():
    # rows: 0 -> {1, 2, 3}, 1 -> {0}, 2 -> {0}, 3 -> {0}
    g = graph_of([(0, 1), (0, 2), (0, 3)], 4)
    n, m = 4, 6
    # X1 top-down: every slot, no base, no row flags, W = 1
    want = (4 * (n + 1) + 4 * m + 4 * min(m, n) + 4 * n * 2) / 3.35e12
    got = costs.segment_or_launch(g.row_ptr, g.col_idx,
                                  torch.zeros(4, 1, dtype=torch.int32),
                                  torch.zeros(4, 1, dtype=torch.int32))
    assert got == pytest.approx(want)
    # X1 fallback from position 1 over row 0 only: 2 slots
    active = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    want = (4 * (n + 1) + 4 * n + 4 * 2 + 4 * 2 + 4 * n * 3) / 3.35e12
    got = costs.segment_or_launch(
        g.row_ptr, g.col_idx, torch.zeros(4, 1, dtype=torch.int32),
        torch.zeros(4, 1, dtype=torch.int32),
        base=torch.zeros(4, 1, dtype=torch.int32), row_active=active,
        min_pos=1)
    assert got == pytest.approx(want)
    # B3: vertex 0 needs lane 0, frontier holds vertex 2 (its 2nd
    # neighbour): rounds 0 and 1 gather, then lane 0 is served
    need = torch.tensor([[1], [0], [0], [0]], dtype=torch.int32)
    front = torch.tensor([[0], [0], [1], [0]], dtype=torch.int32)
    assert costs.lane_probe_work(g.row_ptr, g.col_idx, front, need, 8) == \
        (1, 2, 2)
    want = (8 * n + 8 * 1 + 4 * 2 + 4 * 2) / 3.35e12
    assert costs.msbfs_probe_launch(g.row_ptr, g.col_idx, front, need) == \
        pytest.approx(want)
    # B4 and X2 at max_pos 1 with slot 1 of row 0 excluded (+inf weight)
    w = torch.tensor([0.5, float("inf"), 0.25, 0.5, 0.5, 0.25])
    vals = torch.zeros(4, 2)
    slots, fin, rows = 4, 4, 2      # first slot of each row; rows 0 and 1
    want = (4 * (n + 1) + 4 * (slots + fin) + 4 * 2 * rows
            + 4 * n * 2) / 3.35e12
    assert costs.semiring_relax_launch(g.row_ptr, g.col_idx, w, vals, 1) \
        == pytest.approx(want)
    slots, fin, rows = 2, 1, 1      # row 0's slots 1, 2; one finite
    want = (4 * (n + 1) + 4 * (slots + fin) + 4 * 2 * rows
            + 8 * 1 * 2) / 3.35e12
    assert costs.relax_fallback_launch(g.row_ptr, g.src_idx, g.col_idx, w,
                                       vals, vals.clone(), 1) == \
        pytest.approx(want)
