"""The port's fanout sampler against the JAX package's, and the
neighbour-sampling example on the CPU.

Given the reference's raw draws (its ``randint`` per layer, from the same
key splits), the port's subgraph is the reference's bit for bit: nodes,
senders, receivers and mask, and the assembled batch's features and
labels. The membership and dedup checks are tests/test_substrate.py's.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core.csr import from_numpy_graph
from repro_torch.examples import gnn_neighbor_sampling
from repro_torch.graph.generator import rmat_graph
from repro_torch.graph.sampler import (dedup_count, sample_subgraph,
                                       sampled_graph_batch)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    mod = importlib.import_module
    return SimpleNamespace(
        jax=mod("jax"), jnp=mod("jax.numpy"),
        gen=mod("repro.graph.generator"), sampler=mod("repro.graph.sampler"))


def ref_draws(ref, key, n_seeds, fanout):
    """The reference's draws: ``key, sub = split(key)`` a layer, then
    ``randint(sub, (F, f), 0, 2**30)``."""
    draws, n_f = [], n_seeds
    for f in fanout:
        key, sub = ref.jax.random.split(key)
        r = ref.jax.random.randint(sub, (n_f, f), 0, 1 << 30)
        draws.append(torch.from_numpy(np.array(r)))
        n_f *= f
    return draws


def port_graph(g_ref):
    return from_numpy_graph(np.asarray(g_ref.row_ptr),
                            np.asarray(g_ref.col_idx),
                            np.asarray(g_ref.src_idx), device="cpu")


@pytest.mark.parametrize("scale,seeds,fanout", [
    (9, [1, 5, 9, 200], (3, 2)), (8, list(range(8)), (4,)),
    (10, [0, 3, 77, 1000, 512, 9], (5, 3, 2))])
def test_subgraph_is_the_references_given_its_draws(ref, scale, seeds,
                                                    fanout):
    g_ref = ref.gen.rmat_graph(scale, 8, seed=0)
    g = rmat_graph(scale, 8, seed=0, device="cpu")
    assert torch.equal(g.col_idx, port_graph(g_ref).col_idx)
    key = ref.jax.random.PRNGKey(scale)
    seeds_j = ref.jnp.asarray(seeds, ref.jnp.int32)
    want = ref.sampler.sample_subgraph(key, g_ref, seeds_j, fanout=fanout)
    got = sample_subgraph(None, g, torch.tensor(seeds, dtype=torch.int32),
                          fanout, draws=ref_draws(ref, key, len(seeds),
                                                  fanout))
    for a, b in zip(got, want):
        assert a.dtype in (torch.int32, torch.bool)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n_want = len(seeds) * (1 + np.cumsum(np.cumprod(fanout))[-1])
    assert got[0].shape[0] == n_want


def test_sampled_batch_and_dedup_match_reference(ref):
    g_ref = ref.gen.rmat_graph(9, 8, seed=0)
    g = port_graph(g_ref)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((g.n, 6)).astype(np.float32)
    labels = rng.integers(0, 5, g.n).astype(np.int32)
    key = ref.jax.random.PRNGKey(7)
    seeds = np.array([3, 30, 300], np.int32)
    want = ref.sampler.sampled_graph_batch(
        key, g_ref, ref.jnp.asarray(seeds), ref.jnp.asarray(feats),
        ref.jnp.asarray(labels), fanout=(4, 2), n_classes=5)
    got = sampled_graph_batch(None, g, torch.from_numpy(seeds),
                              torch.from_numpy(feats),
                              torch.from_numpy(labels), fanout=(4, 2),
                              draws=ref_draws(ref, key, 3, (4, 2)))
    for name in ("senders", "receivers", "edge_mask", "feats", "pos",
                 "labels", "node_mask", "graph_ids"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert got.n_graphs == want.n_graphs == 1
    nodes = sample_subgraph(None, g, torch.from_numpy(seeds), (4, 2),
                            draws=ref_draws(ref, key, 3, (4, 2)))[0]
    assert int(dedup_count(nodes, g.n)) == int(ref.sampler.dedup_count(
        ref.jnp.asarray(nodes.numpy()), g.n))


def test_sampler_shapes_and_membership():
    g = rmat_graph(9, 8, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    nodes, senders, receivers, mask = sample_subgraph(
        gen, g, torch.tensor([1, 5, 9, 200], dtype=torch.int32),
        fanout=(3, 2))
    assert nodes.shape[0] == 4 + 12 + 24
    assert senders.shape == receivers.shape == mask.shape
    rp, ci = g.row_ptr.numpy(), g.col_idx.numpy()
    nd, sd, rd, md = (x.numpy() for x in (nodes, senders, receivers, mask))
    for e in range(len(sd)):
        if not md[e]:
            continue
        child, parent = nd[sd[e]], nd[rd[e]]
        assert child in ci[rp[parent]:rp[parent + 1]], (parent, child)


def test_sampler_dedup_count():
    g = rmat_graph(8, 8, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(1)
    nodes, *_ = sample_subgraph(gen, g, torch.arange(8, dtype=torch.int32),
                                fanout=(4,))
    uniq = int(dedup_count(nodes, g.n))
    assert 0 < uniq <= nodes.shape[0]
    assert uniq == len(np.unique(nodes.numpy()))


def test_neighbor_sampling_example_runs_on_cpu(ref, capsys):
    out = gnn_neighbor_sampling.main(["--device", "cpu"])
    g_ref = ref.gen.rmat_graph(12, 8, seed=0)
    assert (out["n"], out["m"]) == (g_ref.n, g_ref.m)
    assert out["steps"] == 30 and len(out["losses"]) == 30
    assert np.isfinite(out["losses"]).all()
    assert out["losses"][-1] < out["losses"][0]
    assert [r["step"] for r in out["rows"]] == [0, 10, 20, 29]
    assert all(r["subgraph_nodes"] == 64 * (1 + 5 + 15)
               and r["unique_seeds"] == 64 for r in out["rows"])
    assert capsys.readouterr().out.rstrip().endswith("done")
