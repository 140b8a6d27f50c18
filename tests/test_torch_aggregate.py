"""The port's ``owner_gather_scatter`` (``distributed/aggregate.py``)
against the JAX package's.

One seeded graph (n = 64 nodes, e = 256 edges, a tenth of them masked,
8 features) and two edge functions: the plain masked sum of GCN and GIN
(``masked``, which runs through a CSR of the rank's edges and the ELL
kernels' plain versions on the CPU) and a masked product with per-edge
weights, a tuple of edge data (MACE's form). The reference's values and
gradients (of the sum of A times fixed random weights, with respect to
the node features and the edge weights) come from its function in this
process. The port runs on four gloo ranks (``run_ranks``) on a 2x2 mesh,
each rank its block of 16 nodes and 64 edges, and must agree within 1e-5
in values and gradients (the gradients through the collectives' autograd
transposes). The fallback rule's three cases run on the same ranks with
whole arrays: no ambient mesh, a mesh of one rank, and a node count (66)
that does not divide by 4.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed.ranks import run_ranks

N, E, D, NDEV = 64, 256, 8, 4
TOL = 1e-5


def graph(n: int = N, seed: int = 0):
    rng = np.random.default_rng(seed)
    return dict(h=rng.standard_normal((n, D)).astype(np.float32),
                snd=rng.integers(0, n, E).astype(np.int32),
                rcv=rng.integers(0, n, E).astype(np.int32),
                mask=rng.random(E) > 0.1,
                w=rng.standard_normal((E, D)).astype(np.float32),
                out_w=rng.standard_normal((n, D)).astype(np.float32))


def _torch_fns():
    from repro_torch.distributed.aggregate import masked

    def weighted(hj, ed):
        w, mask = ed
        return torch.where(mask[:, None], hj * w, 0.0)
    return {"masked": masked, "weighted": weighted}


def _port_case(g, fn_name, lo_n, hi_n, lo_e, hi_e, n_nodes):
    """owner_gather_scatter on rows [lo_n, hi_n) and edges [lo_e, hi_e):
    (A, dA/dh, dA/dw) of those rows and edges, as lists."""
    from repro_torch.distributed.aggregate import owner_gather_scatter
    fn = _torch_fns()[fn_name]
    h = torch.from_numpy(g["h"][lo_n:hi_n]).requires_grad_(True)
    w = torch.from_numpy(g["w"][lo_e:hi_e]).requires_grad_(True)
    mask = torch.from_numpy(g["mask"][lo_e:hi_e])
    ed = mask if fn_name == "masked" else (w, mask)
    a = owner_gather_scatter(h, torch.from_numpy(g["snd"][lo_e:hi_e]),
                             torch.from_numpy(g["rcv"][lo_e:hi_e]), ed, fn,
                             n_nodes)
    (a * torch.from_numpy(g["out_w"][lo_n:hi_n])).sum().backward()
    gw = None if w.grad is None else w.grad.numpy().tolist()
    return a.detach().numpy().tolist(), h.grad.numpy().tolist(), gw


def aggregate_rank():
    """A gloo rank: its block on the 2x2 mesh, and the fallback cases."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    r = dist.get_rank()
    g, g_odd = graph(), graph(N + 2, seed=1)
    mesh = make_mesh((2, 2), ("data", "model"))
    one = make_mesh((4, 1), ("data", "model"))["model"]
    nl, el = N // NDEV, E // NDEV
    out = {}
    for fn in ("masked", "weighted"):
        with use_mesh(mesh):
            out["split", fn] = _port_case(g, fn, r * nl, (r + 1) * nl,
                                          r * el, (r + 1) * el, N)
            out["odd", fn] = _port_case(g_odd, fn, 0, N + 2, 0, E, N + 2)
        with use_mesh(one):
            out["one", fn] = _port_case(g, fn, 0, N, 0, E, N)
        out["none", fn] = _port_case(g, fn, 0, N, 0, E, N)
    every = [None] * NDEV
    dist.all_gather_object(every, out)
    return every


@pytest.fixture(scope="module")
def port():
    return run_ranks(aggregate_rank, NDEV, device="cpu")


def reference(g, fn_name):
    """The reference's (A, dA/dh, dA/dw) on the whole graph, no mesh."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.distributed.aggregate import owner_gather_scatter

    def masked(hj, mask):
        return jnp.where(mask[:, None], hj, 0.0)

    def weighted(hj, ed):
        w, mask = ed
        return jnp.where(mask[:, None], hj * w, 0.0)
    n = g["h"].shape[0]

    def f(h, w):
        ed = g["mask"] if fn_name == "masked" else (w, g["mask"])
        fn = masked if fn_name == "masked" else weighted
        a = owner_gather_scatter(h, g["snd"], g["rcv"], ed, fn, n)
        return jnp.sum(a * g["out_w"]), a
    (_, a), (gh, gw) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(g["h"]), jnp.asarray(g["w"]))
    return np.asarray(a), np.asarray(gh), np.asarray(gw)


def close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=TOL,
                               atol=TOL, err_msg=msg)


@pytest.mark.parametrize("fn_name", ["masked", "weighted"])
def test_split_matches_reference(port, fn_name):
    """Each rank's block of A and of the gradients, stacked in rank order,
    equals the reference's."""
    a, gh, gw = reference(graph(), fn_name)
    blocks = [port[r][("split", fn_name)] for r in range(NDEV)]
    close(np.concatenate([b[0] for b in blocks]), a, "A")
    close(np.concatenate([b[1] for b in blocks]), gh, "dA/dh")
    if fn_name == "weighted":
        close(np.concatenate([b[2] for b in blocks]), gw, "dA/dw")


@pytest.mark.parametrize("case", ["none", "one", "odd"])
@pytest.mark.parametrize("fn_name", ["masked", "weighted"])
def test_fallback_is_unsharded(port, case, fn_name):
    """No mesh, a one-rank mesh, and n = 66 on four ranks: every rank
    computes the whole aggregation, the reference's."""
    a, gh, gw = reference(graph(N + 2, seed=1) if case == "odd" else graph(),
                          fn_name)
    for r in range(NDEV):
        got = port[r][(case, fn_name)]
        close(got[0], a, f"A rank {r}")
        close(got[1], gh, f"dA/dh rank {r}")
        if fn_name == "weighted":
            close(got[2], gw, f"dA/dw rank {r}")
