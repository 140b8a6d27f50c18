"""The port's GIN, EGNN and MACE against the JAX package's, parameters
carried across by name (``params_from_numpy``), on the reference's own
synthetic batches.

GIN sums in another order than the reference's segment sum (the ELL
kernels' plain versions on the CPU), as GCN does, so its logits and loss
agree within 1e-5 and its gradients within rtol 1e-4, atol 1e-6. EGNN and
MACE in float32: losses within rtol 1e-5, every gradient within 1e-5 of the
largest magnitude of its tensor. MACE in bfloat16 rounds at other points
(the port contracts Y with G first): loss within rtol 2e-3, gradients
within 5e-2 of the largest magnitude (measured: 2.3e-4 and 9.3e-3). The
reference's loss and gradients are jitted, once per module.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels.ell_spmm.ops import spmm_aggregate_ref
from repro_torch.models.gnn import egnn as ET
from repro_torch.models.gnn import gin as GT
from repro_torch.models.gnn import mace as MT
from repro_torch.models.gnn import sph as ST
from repro_torch.models.gnn.common import graph_batch_from_numpy
from repro_torch.models.params import flatten, params_from_numpy, unflatten

F32 = dict(loss=1e-5, grad=1e-5)
BF16 = dict(loss=2e-3, grad=5e-2)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    mod = importlib.import_module
    jax = mod("jax")
    common = mod("repro.models.gnn.common")
    node = common.synthetic_graph_batch(jax.random.PRNGKey(0), 100, 400, 8,
                                        n_classes=4)
    drop = np.random.default_rng(0).random(node.n_edges) < 0.25
    return SimpleNamespace(
        jax=jax, jnp=mod("jax.numpy"), common=common,
        gin=mod("repro.models.gnn.gin"), egnn=mod("repro.models.gnn.egnn"),
        mace=mod("repro.models.gnn.mace"), sph=mod("repro.models.gnn.sph"),
        node=node,
        node_masked=node._replace(edge_mask=mod("jax.numpy").asarray(~drop)),
        graph=common.synthetic_graph_batch(jax.random.PRNGKey(0), 60, 200, 16,
                                           n_classes=4, n_graphs=2))


def ref_loss_grads(ref, loss_fn, init_fn, cfg, gb, seed):
    p, _ = init_fn(ref.jax.random.PRNGKey(seed), cfg)
    (loss, _), g = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, b: loss_fn(p, b, cfg), has_aux=True))(p, gb)
    return (params_from_numpy(ref.jax.device_get(p), "cpu"), float(loss),
            params_from_numpy(ref.jax.device_get(g), "cpu"))


def loss_grads(loss_fn, params, gb, cfg):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, _ = loss_fn(leaves, gb, cfg)
    got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return float(loss.detach()), {
        k: torch.zeros_like(v) if g is None else g
        for (k, v), g in zip(leaves.items(), got)}


def assert_grads_scaled(grads, want, tol):
    assert set(grads) == set(want)
    for name, g in grads.items():
        w = want[name].to(torch.float64)
        err = float((g.to(torch.float64) - w).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-12), (name, err)
        assert torch.isfinite(g).all(), name


def rot(a, b, c):
    ca, sa, cb, sb, cc, sc = (np.cos(a), np.sin(a), np.cos(b), np.sin(b),
                              np.cos(c), np.sin(c))
    rz = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    ry = np.array([[cb, 0, sb], [0, 1, 0], [-sb, 0, cb]])
    rx = np.array([[1, 0, 0], [0, cc, -sc], [0, sc, cc]])
    return torch.tensor(rz @ ry @ rx, dtype=torch.float32)


def test_params_flatten_round_trip():
    tree = {"eps": torch.zeros(2), "mlps": [[{"w": torch.ones(1)}]],
            "layers": [{"phi_e": [{"b": torch.ones(3)}]}]}
    flat = flatten(tree)
    assert sorted(flat) == ["eps", "layers.0.phi_e.0.b", "mlps.0.0.w"]
    back = unflatten(flat)
    assert isinstance(back["mlps"], list) and isinstance(back["mlps"][0], list)
    assert back["layers"][0]["phi_e"][0]["b"] is flat["layers.0.phi_e.0.b"]


@pytest.mark.parametrize("case", ["node", "node_masked", "graph"])
def test_gin_matches_reference(ref, case):
    gb_j = getattr(ref, case)
    task = "graph" if case == "graph" else "node"
    kw = dict(d_feat=int(gb_j.feats.shape[1]), n_classes=4, d_hidden=16,
              n_layers=3, task=task)
    cfg_j, cfg = ref.gin.GINConfig(**kw), GT.GINConfig(**kw)
    p, loss_j, g_j = ref_loss_grads(ref, ref.gin.gin_loss, ref.gin.init_gin,
                                    cfg_j, gb_j, 1)
    assert "mlps.2.1.w" in p and p["eps"].shape == (3,)
    logits_j = ref.jax.jit(lambda p, b: ref.gin.gin_forward(p, b, cfg_j))(
        ref.gin.init_gin(ref.jax.random.PRNGKey(1), cfg_j)[0], gb_j)
    gb = graph_batch_from_numpy(gb_j, "cpu")
    np.testing.assert_allclose(GT.gin_forward(p, gb, cfg).numpy(),
                               np.asarray(logits_j), rtol=1e-5, atol=1e-5)
    loss, grads = loss_grads(GT.gin_loss, p, gb, cfg)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5, atol=1e-5)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), g_j[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_gin_aggregates_once_a_layer_forward_and_backward(ref):
    """Every layer's neighbour sum goes through the aggregation (the
    kernels on the card): n_layers calls forward, and n_layers - 1 backward
    (layer 0 sums the input features, which need no gradient)."""
    calls = []

    def counting(g, x, k_max, ell):
        calls.append(x.shape[1])
        return spmm_aggregate_ref(g, x, k_max, ell)

    cfg = GT.GINConfig(d_feat=8, n_classes=4, d_hidden=16, n_layers=3)
    gb = graph_batch_from_numpy(ref.node, "cpu")
    p = {k: v.requires_grad_(True) for k, v in GT.init_gin(
        torch.Generator().manual_seed(0), cfg).items()}
    loss, _ = GT.gin_loss(p, gb, cfg, impl=counting)
    assert calls == [8, 16, 16]
    torch.autograd.grad(loss, list(p.values()))
    assert calls == [8, 16, 16, 16, 16]


def test_egnn_matches_reference(ref):
    kw = dict(d_feat=16, d_hidden=32)
    cfg_j, cfg = ref.egnn.EGNNConfig(**kw), ET.EGNNConfig(**kw)
    p, loss_j, g_j = ref_loss_grads(ref, ref.egnn.egnn_loss,
                                    ref.egnn.init_egnn, cfg_j, ref.graph, 3)
    assert "layers.3.phi_e.0.w" in p and p["layers.3.phi_e.0.w"].shape == (
        65, 32)
    loss, grads = loss_grads(ET.egnn_loss, p,
                             graph_batch_from_numpy(ref.graph, "cpu"), cfg)
    np.testing.assert_allclose(loss, loss_j, rtol=F32["loss"])
    assert_grads_scaled(grads, g_j, F32["grad"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mace_matches_reference(ref, dtype):
    kw = dict(d_feat=16, d_hidden=16, dtype=dtype)
    cfg_j, cfg = ref.mace.MACEConfig(**kw), MT.MACEConfig(**kw)
    p, loss_j, g_j = ref_loss_grads(ref, ref.mace.mace_loss,
                                    ref.mace.init_mace, cfg_j, ref.graph, 4)
    assert p["layers.1.w3"].shape == (3, 16, 16)
    gb = graph_batch_from_numpy(ref.graph, "cpu")
    # the batch has self-loops: their gradient must be finite
    assert bool((gb.senders == gb.receivers).any())
    loss, grads = loss_grads(MT.mace_loss, p, gb, cfg)
    tol = F32 if dtype == "float32" else BF16
    np.testing.assert_allclose(loss, loss_j, rtol=tol["loss"])
    assert_grads_scaled(grads, g_j, tol["grad"])


def test_mace_remat_equals_plain(ref):
    gb = graph_batch_from_numpy(ref.graph, "cpu")
    cfg = MT.MACEConfig(d_feat=16, d_hidden=16)
    p = MT.init_mace(torch.Generator().manual_seed(5), cfg)
    loss, grads = loss_grads(MT.mace_loss, p, gb, cfg)
    loss_r, grads_r = loss_grads(
        MT.mace_loss, p, gb, MT.MACEConfig(d_feat=16, d_hidden=16,
                                           remat=True))
    assert loss == loss_r
    for name in grads:
        assert torch.equal(grads[name], grads_r[name]), name


def test_egnn_and_mace_are_equivariant(ref):
    """As tests/test_models.py checks the reference: energies invariant,
    EGNN's coordinates and MACE's l = 1, 2 block norms rotate along."""
    gb = graph_batch_from_numpy(ref.graph, "cpu")
    r = rot(0.3, 1.1, -0.7)
    cfg = ET.EGNNConfig(d_feat=16, d_hidden=32)
    p = ET.init_egnn(torch.Generator().manual_seed(3), cfg)
    _, x1, e1 = ET.egnn_forward(p, gb, cfg)
    _, x2, e2 = ET.egnn_forward(p, gb._replace(pos=gb.pos @ r.T + 2.5), cfg)
    np.testing.assert_allclose(e1.detach(), e2.detach(), rtol=1e-4)
    np.testing.assert_allclose((x1 @ r.T + 2.5).detach(), x2.detach(),
                               rtol=1e-3, atol=1e-3)
    r = rot(0.5, -0.9, 0.4)
    cfg = MT.MACEConfig(d_feat=16, d_hidden=16)
    p = MT.init_mace(torch.Generator().manual_seed(4), cfg)
    h1, e1 = MT.mace_forward(p, gb, cfg)
    h2, e2 = MT.mace_forward(p, gb._replace(pos=gb.pos @ r.T - 1.5), cfg)
    np.testing.assert_allclose(e1.detach(), e2.detach(), rtol=1e-4)
    for sl in (slice(1, 4), slice(4, 9)):
        np.testing.assert_allclose(h1[:, :, sl].detach().norm(dim=-1),
                                   h2[:, :, sl].detach().norm(dim=-1),
                                   rtol=1e-3, atol=1e-5)


def test_sph_and_gaunt_match_reference(ref):
    assert np.array_equal(ST.gaunt_tensor(), ref.sph.gaunt_tensor())
    assert ST.gaunt_tensor().dtype == np.float32
    assert ST.check_orthonormal() == ref.sph.check_orthonormal() < 1e-10
    u = np.random.default_rng(0).standard_normal((50, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    np.testing.assert_allclose(ST.real_sph(torch.from_numpy(u)).numpy(),
                               np.asarray(ref.sph.real_sph(ref.jnp.asarray(u))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ST.real_sph_np(u), ref.sph.real_sph_np(u))
    r = np.array([0.0, 1e-7, 0.5, 4.9, 6.0], np.float32)
    np.testing.assert_allclose(
        MT.bessel_basis(torch.from_numpy(r), 8, 5.0).numpy(),
        np.asarray(ref.mace.bessel_basis(ref.jnp.asarray(r), 8, 5.0)),
        rtol=1e-5, atol=1e-5)
