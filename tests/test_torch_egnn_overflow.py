"""EGNN's float32 gradient norm at full width, the port against the JAX
package's on the same inputs, on the CPU.

``egnn`` at ``minibatch_lg`` (169,984 nodes, 168,960 edges, 602 features)
with random weights gives losses up to 1e20 and more, so the float32 sum
of squares that ``clip_by_global_norm`` takes can pass float32's range
while every gradient element is finite. The reference's own batch
(``repro.data.pipeline.gnn_batch``, step 0) and parameters (its
``param_builders`` init) go to the port's ``egnn_loss``: seed 3, where the
reference's float32 norm is inf, and seed 1, where it is finite. The
port's float32 norm must be inf exactly where the reference's is, every
port gradient element finite, and the float64 norms within 1e-3
relative.
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch, param_builders
from repro_torch.models.gnn.common import graph_batch_from_numpy
from repro_torch.models.params import params_from_numpy
from repro_torch.optim.adamw import global_norm


def norm64(leaves) -> float:
    return float(np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                             for x in leaves)))


@pytest.mark.parametrize("seed,overflows", [(1, False), (3, True)])
def test_egnn_grad_norm_overflows_where_the_reference_does(seed, overflows):
    pytest.importorskip("jax")
    jax = importlib.import_module("jax")
    base = importlib.import_module("repro.configs.base")
    data = importlib.import_module("repro.data.pipeline")
    adamw = importlib.import_module("repro.optim.adamw")
    arch_j = base.get_arch("egnn")
    shape_j = arch_j.shape("minibatch_lg")
    init_j, loss_j = base.param_builders(arch_j, shape_j)
    p_j, _ = init_j(jax.random.PRNGKey(seed))
    b_j = data.gnn_batch(arch_j, shape_j, 0, seed)
    (_, _), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(p_j, b_j)
    want32 = float(adamw.global_norm(g_j))
    want64 = norm64(jax.tree.leaves(g_j))
    assert np.isfinite(want32) != overflows and np.isfinite(want64)

    arch = get_arch("egnn")
    _, loss_fn = param_builders(arch, arch.shape("minibatch_lg"))
    params = {k: v.requires_grad_(True) for k, v in params_from_numpy(
        jax.device_get(p_j), "cpu").items()}
    del p_j, g_j
    loss, _ = loss_fn(params, graph_batch_from_numpy(b_j, "cpu"))
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    # a parameter the loss does not reach has a zero gradient, as in the
    # reference's tree
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), got)}
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    got32 = float(global_norm(grads))
    got64 = norm64(g.numpy() for g in grads.values())
    assert np.isfinite(got32) == np.isfinite(want32), (got32, want32)
    np.testing.assert_allclose(got64, want64, rtol=1e-3)
