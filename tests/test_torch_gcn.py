"""The port's GCN against the JAX package's, parameters carried across.

The batch is the one of tests/test_models.py::test_gnn_grads_flow
(``synthetic_graph_batch(PRNGKey(0), 100, 400, 8, n_classes=4)``), as is,
and with a quarter of its edges masked out; both ``norm`` values. On the
CPU the sum aggregation takes the kernels' plain versions. The two sides
sum in other orders, so logits and loss agree within 1e-5 and gradients
within rtol 1e-4, atol 1e-6.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.models import layers as L
from repro_torch.models.gnn.common import (aggregate, degrees,
                                           graph_batch_from_numpy, graph_pool,
                                           synthetic_graph_batch)
from repro_torch.models.gnn.gcn import (GCN, GCNConfig, gcn_forward,
                                        gcn_loss, gcn_params_from_numpy,
                                        init_gcn)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    mod = importlib.import_module
    return SimpleNamespace(
        jax=mod("jax"), jnp=mod("jax.numpy"),
        common=mod("repro.models.gnn.common"),
        gcn=mod("repro.models.gnn.gcn"), layers=mod("repro.models.layers"))


def ref_batch(ref, masked):
    gb = ref.common.synthetic_graph_batch(ref.jax.random.PRNGKey(0), 100, 400,
                                          8, n_classes=4)
    if masked:
        drop = np.random.default_rng(0).random(gb.n_edges) < 0.25
        gb = gb._replace(edge_mask=ref.jnp.asarray(~drop))
    return gb


def grads_of(params, gb, cfg):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, _ = gcn_loss(leaves, gb, cfg)
    return loss, dict(zip(leaves, torch.autograd.grad(loss,
                                                      list(leaves.values()))))


@pytest.mark.parametrize("norm", ["sym", "mean"])
@pytest.mark.parametrize("masked", [False, True])
def test_gcn_matches_reference(ref, norm, masked):
    gb_j = ref_batch(ref, masked)
    cfg_j = ref.gcn.GCNConfig(d_feat=8, n_classes=4, norm=norm)
    p_j, _ = ref.gcn.init_gcn(ref.jax.random.PRNGKey(1), cfg_j)
    logits_j = ref.gcn.gcn_forward(p_j, gb_j, cfg_j)
    (loss_j, _), g_j = ref.jax.value_and_grad(
        lambda p: ref.gcn.gcn_loss(p, gb_j, cfg_j), has_aux=True)(p_j)

    cfg = GCNConfig(d_feat=8, n_classes=4, norm=norm)
    params = gcn_params_from_numpy(ref.jax.device_get(p_j), "cpu")
    assert sorted(params) == ["layers.0.b", "layers.0.w", "layers.1.b",
                              "layers.1.w"]
    assert params["layers.0.w"].shape == (8, 16)
    gb = graph_batch_from_numpy(gb_j, "cpu")
    logits = gcn_forward(params, gb, cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               rtol=1e-5, atol=1e-5)
    loss, grads = grads_of(params, gb, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5,
                               atol=1e-5)
    want = gcn_params_from_numpy(ref.jax.device_get(g_j), "cpu")
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_gcn_module_runs_gcn_forward():
    cfg = GCNConfig(d_feat=6, n_classes=3)
    gen = torch.Generator().manual_seed(0)
    params = init_gcn(gen, cfg)
    gb = synthetic_graph_batch(torch.Generator().manual_seed(1), 40, 150, 6,
                               n_classes=3)
    model = GCN(cfg, params)
    assert [n for n, _ in model.named_parameters()] == list(params)
    assert torch.equal(model(gb), gcn_forward(params, gb, cfg))


def test_dense_init_and_xent_match_reference(ref):
    gen = torch.Generator().manual_seed(3)
    p = L.dense(gen, 400, 30, bias=True)
    assert p["w"].shape == (400, 30) and not p["b"].any()
    # normal * 1/sqrt(fan_in): the standard deviation is 0.05
    assert abs(float(p["w"].std()) - 0.05) < 0.002
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((50, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 50).astype(np.int32)
    mask = rng.random(50) < 0.7
    for m in (None, mask):
        want = ref.layers.softmax_xent(
            ref.jnp.asarray(logits), ref.jnp.asarray(labels),
            None if m is None else ref.jnp.asarray(m))
        got = L.softmax_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels),
                             None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_segment_ops_match_reference(ref, op):
    gb_j = ref.common.synthetic_graph_batch(ref.jax.random.PRNGKey(2), 30, 90,
                                            4, n_graphs=3)
    drop = np.random.default_rng(1).random(gb_j.n_edges) < 0.3
    gb_j = gb_j._replace(edge_mask=ref.jnp.asarray(~drop))
    gb = graph_batch_from_numpy(gb_j, "cpu")
    msg_j = gb_j.feats[gb_j.senders]
    want = ref.common.aggregate(msg_j, gb_j.receivers, 30, gb_j.edge_mask,
                                op=op)
    got = aggregate(gb.feats[gb.senders.long()], gb.receivers, 30,
                    gb.edge_mask, op=op)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(degrees(gb).numpy(),
                                  np.asarray(ref.common.degrees(gb_j)))
    np.testing.assert_allclose(
        graph_pool(gb.feats, gb).numpy(),
        np.asarray(ref.common.graph_pool(gb_j.feats, gb_j)), rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("n_graphs", [1, 4])
def test_synthetic_graph_batch_is_seeded_and_shaped(n_graphs):
    def draw(seed):
        return synthetic_graph_batch(torch.Generator().manual_seed(seed), 40,
                                     300, 5, n_classes=3, n_graphs=n_graphs)
    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a.feats, b.feats) and torch.equal(a.senders, b.senders)
    assert not torch.equal(a.feats, c.feats)
    assert a.n_nodes == 40 and a.n_edges == 300 and a.n_graphs == n_graphs
    assert a.senders.dtype == torch.int32 and a.labels.dtype == torch.int32
    assert int(a.labels.max()) < 3 and bool(a.edge_mask.all())
    per = 40 // n_graphs
    # edges stay inside their graph
    assert torch.equal(a.graph_ids[a.senders.long()],
                       a.graph_ids[a.receivers.long()])
    assert torch.equal(a.senders // per, a.receivers // per)
