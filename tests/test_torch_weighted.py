"""The port's weighted generator and CSR against ``repro.graph.generator``
and ``repro.core.csr``.

The generators are copied numpy code, so a seed gives the same edges and
weights in both packages: arrays are compared for exact equality (float32
weights bit for bit)."""
import numpy as np
import pytest

from repro.core.csr import from_weighted_edges as jfrom_weighted_edges
from repro.graph import generator as jgen
from repro_torch.core.csr import (WeightedCSRGraph, from_numpy_weighted_graph,
                                  from_weighted_edges)
from repro_torch.graph import generator as gen

FIELDS = ("row_ptr", "col_idx", "src_idx", "weights")


def assert_graphs_equal(got, want):
    assert isinstance(got, WeightedCSRGraph)
    for name in FIELDS:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=name)


@pytest.mark.parametrize("m,seed,weight_range", [(1000, 0, (0.0, 1.0)),
                                                 (37, 5, (0.5, 4.0)),
                                                 (0, 1, (0.0, 1.0))])
def test_edge_weights_bit_equal(m, seed, weight_range):
    np.testing.assert_array_equal(gen.edge_weights(m, seed, weight_range),
                                  jgen.edge_weights(m, seed, weight_range))


def test_edge_weights_reject_bad_range():
    with pytest.raises(ValueError, match="0 <= lo <= hi"):
        gen.edge_weights(4, 0, (1.0, 0.5))


@pytest.mark.parametrize("scale,ef,seed", [(7, 4, 2), (9, 16, 0)])
def test_rmat_weighted_graph_bit_equal(scale, ef, seed):
    got = gen.rmat_weighted_graph(scale, ef, seed, device="cpu")
    assert_graphs_equal(got, jgen.rmat_weighted_graph(scale, ef, seed))
    # the unweighted view is the unweighted generator's graph
    plain = gen.rmat_graph(scale, ef, seed, device="cpu")
    for a, b in zip(got.csr, plain):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n,m,seed", [(90, 500, 5), (300, 1500, 11)])
def test_uniform_random_weighted_graph_bit_equal(n, m, seed):
    assert_graphs_equal(
        gen.uniform_random_weighted_graph(n, m, seed, device="cpu"),
        jgen.uniform_random_weighted_graph(n, m, seed))


def test_symmetric_weights():
    wg = from_weighted_edges(np.asarray([0, 1]), np.asarray([1, 2]),
                             np.asarray([0.5, 2.0]), 3, device="cpu")
    lut = {(int(u), int(v)): float(w) for u, v, w in
           zip(wg.src_idx, wg.col_idx, wg.weights)}
    assert lut[(0, 1)] == lut[(1, 0)] == 0.5
    assert lut[(1, 2)] == lut[(2, 1)] == 2.0


@pytest.mark.parametrize("dedup", [False, True])
def test_parallel_edges_match_reference(dedup):
    """Parallel edges are sorted by weight within a row, so dedup keeps the
    minimum-weight copy."""
    src, dst = np.asarray([0, 0, 0, 2, 1]), np.asarray([1, 1, 1, 0, 2])
    w = np.asarray([3.0, 1.0, 2.0, 0.25, 0.0])
    got = from_weighted_edges(src, dst, w, 3, dedup=dedup, device="cpu")
    assert_graphs_equal(got, jfrom_weighted_edges(src, dst, w, 3,
                                                  dedup=dedup))
    if dedup:
        assert got.m == 6
        assert float(got.weights[got.row_ptr[0]]) == 1.0


@pytest.mark.parametrize("bad", [-0.5, np.nan, np.inf, -np.inf])
def test_rejects_invalid_weights(bad):
    for build in (from_weighted_edges, jfrom_weighted_edges):
        kw = {"device": "cpu"} if build is from_weighted_edges else {}
        with pytest.raises(ValueError, match="invalid edge weight"):
            build(np.asarray([0, 1]), np.asarray([1, 2]),
                  np.asarray([1.0, bad]), 3, **kw)


def test_weights_shape_must_match_edges():
    with pytest.raises(ValueError, match="weights shape"):
        from_weighted_edges(np.asarray([0, 1]), np.asarray([1, 2]),
                            np.asarray([1.0]), 3, device="cpu")


def test_from_numpy_weighted_graph_carries_reference_graph():
    jg = jgen.rmat_weighted_graph(8, 8, seed=3)
    got = from_numpy_weighted_graph(
        *(np.asarray(getattr(jg, f)) for f in FIELDS), device="cpu")
    assert_graphs_equal(got, jg)
    assert got.n == jg.n and got.m == jg.m
    np.testing.assert_array_equal(got.deg.numpy(), np.asarray(jg.deg))
