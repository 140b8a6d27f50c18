"""The port's GNN aggregation against the JAX package's.

The ELL slab sum (kernel ell_spmm) and its residue fold (kernel
spmm_residue) take their plain PyTorch versions here, on the CPU; the
Pallas kernel runs in interpret mode, as the JAX package's own tests run
it. Float32 sums are taken in other orders on the two sides, so the
tolerances are those of the reference's own tests: 1e-5 for the slab sum
(tests/test_kernels.py::test_ell_spmm_sweep), 3e-5 for the whole
aggregation (test_spmm_aggregate_exact_vs_dense), 1e-5 for the backward.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.csr import from_numpy_graph
from repro_torch.kernels import (ell_spmm_ref, spmm_aggregate,
                                 spmm_residue_ref)
from repro_torch.kernels.ell_spmm.ops import ell_spmm, spmm_aggregate_ref
from repro_torch.kernels.spmm_residue.ops import spmm_residue
from repro_torch.models.gnn.common import (GraphBatch, build_adjacency,
                                           sum_aggregate)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's pieces these tests hold the port against."""
    pytest.importorskip("jax")
    mod = importlib.import_module
    csr = mod("repro.core.csr")
    gen = mod("repro.graph.generator")
    ops = mod("repro.kernels.ell_spmm.ops")
    return SimpleNamespace(
        jax=mod("jax"), jnp=mod("jax.numpy"), csr=csr,
        uniform=gen.uniform_random_graph, rmat=gen.rmat_graph,
        pallas=mod("repro.kernels.ell_spmm.kernel").ell_spmm_pallas,
        slab_ref=mod("repro.kernels.ell_spmm.ref").ell_spmm_ref,
        aggregate=ops.spmm_aggregate)


def port_graph(jg):
    return from_numpy_graph(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                            np.asarray(jg.src_idx), "cpu")


def features(n, d, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(dtype)


def dense_sum(rp, ci, x, k_lo=0):
    """Float64 oracle: each row's neighbours at positions >= k_lo."""
    out = np.zeros((len(rp) - 1, x.shape[1]), np.float64)
    for v in range(len(rp) - 1):
        for u in ci[rp[v] + k_lo:rp[v + 1]]:
            out[v] += x[u]
    return out


@pytest.mark.parametrize("d", [16, 64, 130])
@pytest.mark.parametrize("k_max", [4, 16])
def test_ell_spmm_plain_matches_pallas(ref, d, k_max):
    """The reference test's graphs and widths: the port's plain slab sum
    against the Pallas kernel (interpret mode) and the reference's oracle."""
    jg = ref.uniform(500, 3000, seed=d + k_max)
    x = features(jg.n, d, d + k_max)
    neigh, valid = ref.csr.ell_pad(jg, k_max)
    want_pallas = np.asarray(ref.pallas(neigh, valid, ref.jnp.asarray(x),
                                        interpret=True))
    want_ref = np.asarray(ref.slab_ref(neigh, valid, ref.jnp.asarray(x)))
    neigh_t = torch.from_numpy(np.array(neigh))
    valid_t = torch.from_numpy(np.array(valid))
    got = ell_spmm_ref(neigh_t, valid_t, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (jg.n, d)
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-5)
    # the CPU wrapper takes the plain version
    same = ell_spmm(neigh_t, valid_t, torch.from_numpy(x))
    assert torch.equal(same, got)


@pytest.mark.parametrize("k_max", [0, 1, 4, 16])
def test_spmm_residue_plain_matches_oracle(ref, k_max):
    """The residue fold adds exactly the slots at positions >= k_max, in
    place, and leaves rows of degree <= k_max as they were."""
    jg = ref.rmat(8, 16, seed=3)
    g = port_graph(jg)
    # float64, so the oracle's sum (same slot order) is met to rounding
    x = features(g.n, 5, k_max, np.float64)
    base = torch.from_numpy(features(g.n, 5, 100 + k_max, np.float64))
    y = base.clone()
    out = spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx,
                           torch.from_numpy(x), y, k_max)
    assert out is y
    rp, ci = (np.asarray(a) for a in (jg.row_ptr, jg.col_idx))
    want = base.numpy() + dense_sum(rp, ci, x, k_max)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-12, atol=1e-12)
    shallow = (g.deg <= k_max).numpy()
    assert shallow.any() and (~shallow).any()
    assert torch.equal(y[shallow], base[shallow])
    y2 = base.clone()
    spmm_residue(g, torch.from_numpy(x), y2, k_max)
    assert torch.equal(y2, y)


@pytest.mark.parametrize("graph", ["uniform", "rmat"])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_spmm_aggregate_matches_reference(ref, graph, use_pallas):
    """The whole aggregation (slab + residue) against the reference's, on
    the reference test's graph at k_max = 8 and on an R-MAT scale-8 graph,
    both with rows of degree 0 and rows deeper than k_max."""
    jg = (ref.uniform(200, 2000, seed=5) if graph == "uniform"
          else ref.rmat(8, 16, seed=1))
    g = port_graph(jg)
    deg = g.deg.numpy()
    if graph == "rmat":
        assert (deg == 0).any()
    assert (deg > 8).any()
    x = features(g.n, 32, 1)
    want = np.asarray(ref.aggregate(jg, ref.jnp.asarray(x), k_max=8,
                                    use_pallas=use_pallas))
    got = spmm_aggregate(g, torch.from_numpy(x), k_max=8)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    rp, ci = np.asarray(jg.row_ptr), np.asarray(jg.col_idx)
    np.testing.assert_allclose(got.numpy(), dense_sum(rp, ci, x), rtol=3e-5,
                               atol=3e-5)


def test_spmm_aggregate_more_source_rows_than_graph_rows(ref):
    """x may have more rows than the graph (n_src != n): a local row block
    against a wider feature table. Padded slots (id n) are never read."""
    jg = ref.uniform(60, 300, seed=2)
    g = port_graph(jg)
    x = features(g.n + 40, 7, 2)
    x[g.n:] = np.nan  # rows only a padded slot could reach
    got = spmm_aggregate(g, torch.from_numpy(x), k_max=4)
    rp, ci = np.asarray(jg.row_ptr), np.asarray(jg.col_idx)
    np.testing.assert_allclose(got.numpy(), dense_sum(rp, ci, x[:g.n]),
                               rtol=3e-5, atol=3e-5)


def small_batch(n, e, d, seed, masked_quarter=True):
    rng = np.random.default_rng(seed)
    snd = rng.integers(0, n, e).astype(np.int32)
    rcv = rng.integers(0, n, e).astype(np.int32)
    snd[:4] = rcv[:4] = 0          # a hub of multi-edges at vertex 0
    snd[4:30] = 1                  # vertex 1 sends to many: a deep transpose
    mask = np.ones(e, bool)
    if masked_quarter:
        mask[rng.random(e) < 0.25] = False
    t = torch.from_numpy
    return GraphBatch(
        senders=t(snd), receivers=t(rcv), edge_mask=t(mask),
        feats=t(features(n, d, seed)), pos=torch.zeros((n, 3)),
        labels=torch.zeros(n, dtype=torch.int32),
        node_mask=torch.ones(n, dtype=torch.bool),
        graph_ids=torch.zeros(n, dtype=torch.int32)), snd, rcv, mask


def test_adjacency_is_the_live_edges_and_their_transpose():
    gb, snd, rcv, mask = small_batch(30, 120, 3, 0)
    adj = build_adjacency(gb, k_max=4)
    for g, rows, cols in ((adj.fwd, rcv, snd), (adj.bwd, snd, rcv)):
        rp, ci = g.row_ptr.numpy(), g.col_idx.numpy()
        # a fixed-size CSR: every edge slot kept, the masked ones dead
        # after row_ptr[n] (row n)
        assert rp[-1] == mask.sum() and g.m == len(mask)
        for v in range(30):
            live = (rows == v) & mask
            # multi-edges kept, in their input order (a stable sort by row)
            assert ci[rp[v]:rp[v + 1]].tolist() == cols[live].tolist()
        assert torch.equal(g.src_idx, torch.cat([torch.repeat_interleave(
            torch.arange(30, dtype=torch.int32), g.deg.long()),
            torch.full((len(mask) - rp[-1],), 30, dtype=torch.int32)]))
    assert adj.fwd_ell[0].shape == (30, 4) and adj.k_max == 4


def test_sum_aggregate_gradcheck():
    """The autograd Function in float64: the backward (the aggregation over
    the transposed graph) is the forward's exact adjoint."""
    gb, *_ = small_batch(30, 120, 3, 1)
    adj = build_adjacency(gb, k_max=4)
    h = torch.from_numpy(features(30, 3, 9, np.float64)).requires_grad_()
    assert torch.autograd.gradcheck(lambda t: sum_aggregate(t, adj), (h,))


def test_sum_aggregate_backward_matches_jax_vjp(ref):
    """The backward against jax.vjp of the reference's spmm_aggregate
    (use_pallas=False) over the same live edges."""
    gb, snd, rcv, mask = small_batch(40, 200, 6, 2)
    adj = build_adjacency(gb, k_max=4)
    jg = ref.csr.from_edges(rcv[mask], snd[mask], 40, symmetrize=False,
                            drop_self_loops=False)
    x = features(40, 6, 3)
    ct = features(40, 6, 4)
    y_j, vjp = ref.jax.vjp(
        lambda t: ref.aggregate(jg, t, k_max=4, use_pallas=False),
        ref.jnp.asarray(x))
    (gx_j,) = vjp(ref.jnp.asarray(ct))
    h = torch.from_numpy(x).requires_grad_()
    y = sum_aggregate(h, adj)
    y.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(gx_j), rtol=1e-5,
                               atol=1e-5)


def test_plain_aggregation_is_the_cpu_path_and_keeps_float64():
    gb, *_ = small_batch(30, 120, 5, 3)
    adj = build_adjacency(gb, k_max=4)
    x = torch.from_numpy(features(30, 5, 5, np.float64))
    a = spmm_aggregate(adj.fwd, x, 4, adj.fwd_ell)
    b = spmm_aggregate_ref(adj.fwd, x, 4)
    assert a.dtype == torch.float64 and torch.equal(a, b)
    with pytest.raises(ValueError, match="ell slab"):
        spmm_aggregate(adj.fwd, x, 8, adj.fwd_ell)
