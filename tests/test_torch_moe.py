"""The port's MoE FFN against the JAX package's, on the CPU: ``moe_ffn``
with capacity drops (capacity factor 0.5) and with token chunking (a small
``token_chunk``), its aux loss and gradients, ``moe_ffn_dense_ref``, and
``moe_capacity``; from the reference's parameters carried across
(``params_from_numpy``).

Tolerances: float32 outputs and gradients within 1e-5 of the largest
magnitude of each tensor, the aux loss within rtol 1e-5; the dispatch
against the dense version within tests/test_models.py's rtol 3e-4, atol
3e-5; bfloat16 experts within 2e-2 of the largest magnitude.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.models import moe as M
from repro_torch.models.params import params_from_numpy

F32 = 1e-5


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    mod = importlib.import_module
    return SimpleNamespace(jax=mod("jax"), jnp=mod("jax.numpy"),
                           moe=mod("repro.models.moe"))


def cfgs(ref, **kw):
    return ref.moe.MoEConfig(**kw), M.MoEConfig(**kw)


def setup(ref, cfg_j, d, t, seed, dtype="float32"):
    p, _ = ref.moe.moe_init(ref.jax.random.PRNGKey(seed), d, cfg_j,
                            ref.jnp.dtype(dtype))
    x = np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)
    return p, x


def assert_scaled(got, want, tol, msg=""):
    g = got.detach().to(torch.float64)
    w = torch.from_numpy(np.asarray(want, dtype=np.float64))
    assert g.shape == w.shape, msg
    err = float((g - w).abs().max())
    assert err <= tol * max(float(w.abs().max()), 1e-12), (msg, err)


def port_grads(p, x, cfg):
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xl = x.clone().requires_grad_(True)
    y, aux = M.moe_ffn(leaves, xl, cfg)
    out = (y * torch.linspace(-1, 1, y.shape[1])).sum() + aux
    got = torch.autograd.grad(out, [xl] + list(leaves.values()))
    return y.detach(), aux.detach(), dict(zip(["x"] + list(leaves), got))


CASES = {
    # 96 tokens x top-2 over 8 experts, capacity 0.5 x 24 -> 16: drops
    "drops": dict(kw=dict(num_experts=8, top_k=2, d_ff_expert=24,
                          capacity_factor=0.5), d=32, t=96),
    # 4 chunks of 32 tokens, each with its own capacity
    "chunked": dict(kw=dict(num_experts=6, top_k=3, d_ff_expert=16,
                            capacity_factor=1.0, token_chunk=32), d=24,
                    t=128),
    "no_drops": dict(kw=dict(num_experts=8, top_k=2, d_ff_expert=32,
                             capacity_factor=4.0), d=64, t=96),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_reference(ref, case):
    c = CASES[case]
    cfg_j, cfg = cfgs(ref, **c["kw"])
    p_j, x = setup(ref, cfg_j, c["d"], c["t"], 3)
    jax, jnp = ref.jax, ref.jnp
    w = jnp.linspace(-1, 1, c["d"])

    def f(p, x):
        y, aux = ref.moe.moe_ffn(p, x, cfg_j)
        return (y * w).sum() + aux, (y, aux)
    (_, (y_j, aux_j)), g_j = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p_j, jnp.asarray(x))
    p = params_from_numpy(jax.device_get(p_j), "cpu")
    y, aux, grads = port_grads(p, torch.from_numpy(x), cfg)
    assert_scaled(y, y_j, F32, "y")
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)
    assert float(aux) >= 0
    want = dict(params_from_numpy(jax.device_get(g_j[0]), "cpu"),
                x=np.asarray(g_j[1]))
    for name, g in grads.items():
        assert_scaled(g, np.asarray(want[name]), F32, name)
    if case == "drops":
        # some assignments were dropped: a token whose both were dropped
        # has a zero row, and every row is finite
        assert M.moe_capacity(c["t"], cfg) == 16
        assert bool(torch.isfinite(y).all())
        assert bool((y.abs().sum(1) == 0).any())
    if case == "no_drops":
        dense = M.moe_ffn_dense_ref(p, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(y.numpy(), dense.numpy(), rtol=3e-4,
                                   atol=3e-5)
    # the same inputs give the same bits again
    assert torch.equal(M.moe_ffn(p, torch.from_numpy(x), cfg)[0], y)


def test_moe_dense_ref_matches_reference(ref):
    cfg_j, cfg = cfgs(ref, num_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=4.0)
    p_j, x = setup(ref, cfg_j, 64, 40, 5)
    want = ref.moe.moe_ffn_dense_ref(p_j, ref.jnp.asarray(x), cfg_j)
    got = M.moe_ffn_dense_ref(params_from_numpy(ref.jax.device_get(p_j),
                                                "cpu"),
                              torch.from_numpy(x), cfg)
    assert_scaled(got, want, F32)


def test_moe_bfloat16_matches_reference(ref):
    """bfloat16 experts (the router stays float32): the combine sums each
    token's k rows in ascending expert id, in bfloat16, as the
    reference's scatter does."""
    cfg_j, cfg = cfgs(ref, num_experts=8, top_k=4, d_ff_expert=16,
                      capacity_factor=1.0)
    p_j, x = setup(ref, cfg_j, 32, 64, 7, dtype="bfloat16")
    y_j, aux_j = ref.jax.jit(lambda p, x: ref.moe.moe_ffn(p, x, cfg_j))(
        p_j, ref.jnp.asarray(x, ref.jnp.bfloat16))
    p = params_from_numpy(ref.jax.device_get(p_j), "cpu")
    assert p["router"].dtype == torch.float32
    assert p["w1"].dtype == torch.bfloat16
    y, aux = M.moe_ffn(p, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16
    assert_scaled(y, np.asarray(y_j.astype("float32")), 2e-2)
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)


def test_moe_capacity_and_init_match_reference(ref):
    for n in (1, 7, 64, 1000, 16384):
        for kw in (dict(num_experts=32, top_k=8, d_ff_expert=1),
                   dict(num_experts=8, top_k=2, d_ff_expert=1,
                        capacity_factor=2.0),
                   dict(num_experts=4, top_k=1, d_ff_expert=1,
                        capacity_factor=0.5)):
            cfg_j, cfg = cfgs(ref, **kw)
            assert M.moe_capacity(n, cfg) == ref.moe.moe_capacity(n, cfg_j)
    assert M.moe_capacity(16384, M.MoEConfig(32, 8, 512)) == 5120
    p = M.moe_init(torch.Generator().manual_seed(0), 16,
                   M.MoEConfig(4, 2, 8), torch.bfloat16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((16, 4), torch.float32),
        "w1": ((4, 16, 8), torch.bfloat16),
        "w3": ((4, 16, 8), torch.bfloat16),
        "w2": ((4, 8, 16), torch.bfloat16)}
