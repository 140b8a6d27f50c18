"""The fixed-size CSR of ``core/csr.py::from_edge_tensors`` and the meta
routes of the GNN aggregation kernels.

``from_edge_tensors`` keeps all E edge slots: a masked edge is keyed to
row n, so the stable sort puts it after every live edge and ``row_ptr[n]``
is the live count. Its live part must be bit-equal to the CSR it gave
before, which dropped the masked edges with ``nonzero`` first and is kept
here as the oracle (``nonzero_csr``), on masks with nothing, everything, a
leading run, a trailing run or scattered edges masked, and on E = 0; the
aggregation over both CSRs must give the same bits on the CPU, and the
residue's plain version must ignore the dead slots. On meta tensors the two
kernels' custom ops give the kernels' output shapes and count as one op
each under ``CountingMode`` (their inputs read, their output written, the
registered FLOPs), and a reduced GCN and GIN step trace whole. The
aggregation over the fixed-size CSR is held against the JAX package's
``spmm_aggregate`` over the live edges, at the reference's own tolerance
(3e-5, ``tests/test_kernels.py``).
"""
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs.base import make_step, step_arg_specs
from repro_torch.configs.reduced import reduce_arch
from repro_torch.core.csr import CSRGraph, ell_pad, from_edge_tensors
from repro_torch.kernels.ell_spmm.ops import (ell_spmm, spmm_aggregate,
                                              spmm_aggregate_ref)
from repro_torch.kernels.spmm_residue.ops import spmm_residue
from repro_torch.kernels.spmm_residue.ref import spmm_residue_ref
from repro_torch.launch import roofline as rl
from repro_torch.models.gnn.common import edge_adjacency

N, E = 40, 300
MASKS = ("none", "all", "leading", "trailing", "scattered", "empty")


def nonzero_csr(rows, cols, mask, n) -> CSRGraph:
    """The CSR ``from_edge_tensors`` gave before it kept dead slots: the
    masked edges dropped first (``nonzero``, a host read of the kept
    count), then the same stable sort by row."""
    keep = mask.nonzero().squeeze(1)
    rows, cols = rows[keep], cols[keep]
    src, order = torch.sort(rows.to(torch.int32), stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int32)
    return CSRGraph(row_ptr=torch.searchsorted(src, bounds, out_int32=True),
                    col_idx=cols.to(torch.int32)[order], src_idx=src)


def edges(kind: str, seed: int = 0, n: int = N, e: int = E):
    """(rows, cols, mask) of ``e`` random edges over ``n`` rows, with a hub
    at row 0 (deeper than the slab) and the mask ``kind``."""
    if kind == "empty":
        e = 0
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, e).astype(np.int32)
    cols = rng.integers(0, n, e).astype(np.int32)
    rows[: e // 6] = 0
    mask = np.ones(e, bool)
    if kind == "all":
        mask[:] = False
    elif kind == "leading":
        mask[: e // 3] = False
    elif kind == "trailing":
        mask[e - e // 3:] = False
    elif kind == "scattered":
        mask[rng.random(e) < 0.3] = False
    t = torch.from_numpy
    return t(rows), t(cols), t(mask)


@pytest.mark.parametrize("kind", MASKS)
def test_live_part_equals_nonzero_csr(kind):
    rows, cols, mask = edges(kind)
    got = from_edge_tensors(rows, cols, mask, N)
    want = nonzero_csr(rows, cols, mask, N)
    live = int(mask.sum())
    assert got.m == rows.shape[0] and got.n == N
    assert torch.equal(got.row_ptr, want.row_ptr)
    assert int(got.row_ptr[N]) == live
    assert torch.equal(got.col_idx[:live], want.col_idx)
    assert torch.equal(got.src_idx[:live], want.src_idx)
    assert bool((got.src_idx[live:] == N).all())
    assert torch.equal(got.deg, want.deg)
    for a, b in zip(ell_pad(got, 4), ell_pad(want, 4)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("k_max", [2, 16])
def test_spmm_aggregate_bit_equal_over_both_csrs(kind, k_max):
    rows, cols, mask = edges(kind, seed=1)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (N, 6)).astype(np.float32))
    got = spmm_aggregate(from_edge_tensors(rows, cols, mask, N), x, k_max)
    want = spmm_aggregate(nonzero_csr(rows, cols, mask, N), x, k_max)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_residue_plain_version_ignores_dead_slots():
    """Dead slots lie at positions past k_max of row n, and every masked
    edge names a source row no live edge names, whose features are huge:
    were a dead slot read, it would land in y (or out of range)."""
    rows, cols, mask = edges("trailing", seed=3)
    cols = torch.where(mask, cols % (N - 1), N - 1)
    g = from_edge_tensors(rows, cols, mask, N)
    assert g.m - int(g.row_ptr[N]) > 4
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (N, 5)).astype(np.float32))
    x[N - 1] = 1e30
    live = nonzero_csr(rows, cols, mask, N)
    y0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (N, 5)).astype(np.float32))
    got = spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx, x, y0.clone(), 4)
    want = spmm_residue_ref(live.row_ptr, live.src_idx, live.col_idx, x,
                            y0.clone(), 4)
    assert torch.equal(got, want) and bool((got.abs() < 1e29).all())
    assert not torch.equal(got, y0)          # the live tails were added
    assert torch.equal(spmm_residue(g, x, y0.clone(), 4), want)


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("kernel", ["ell_spmm", "spmm_residue"])
def test_meta_custom_op_counts_as_its_kernel(kernel):
    n, k_max, m, n_src, d = 1000, 16, 9000, 1200, 24
    x = meta(n_src, d)
    if kernel == "ell_spmm":
        neigh, valid = meta(n, k_max, dtype=torch.int32), \
            meta(n, k_max, dtype=torch.bool)
        ins = (neigh, valid, x)
        with rl.CountingMode() as cm:
            y = ell_spmm(neigh, valid, x)
        flops = 2 * n * k_max * d
    else:
        rp = meta(n + 1, dtype=torch.int32)
        si, ci = meta(m, dtype=torch.int32), meta(m, dtype=torch.int32)
        y0 = meta(n, d)
        ins = (rp, si, ci, x, y0)
        with rl.CountingMode() as cm:
            y = spmm_residue(CSRGraph(rp, ci, si), x, y0, k_max)
        flops = 2 * m * d
    assert y.is_meta and y.shape == (n, d) and y.dtype == torch.float32
    assert cm.ops == 1
    assert cm.hbm_bytes == rl._nbytes(ins) + rl._nbytes([y])
    assert cm.flops == flops
    assert cm.kernels == {kernel: dict(ops=1, flops=flops)}


def test_meta_custom_ops_refuse_other_devices():
    x = torch.zeros((3, 2))
    with pytest.raises(ValueError, match="meta tensors only"):
        torch.ops.repro_torch.ell_spmm(torch.zeros((3, 1), dtype=torch.int32),
                                       torch.ones((3, 1), dtype=torch.bool), x)
    g = from_edge_tensors(*edges("none", n=3, e=4), 3)
    with pytest.raises(ValueError, match="meta tensors only"):
        torch.ops.repro_torch.spmm_residue(g.row_ptr, g.src_idx, g.col_idx,
                                           x, x.clone(), 1)


def test_edge_adjacency_traces_on_meta():
    """A rank's adjacency under the sharded step: its own edges over all
    of the graph's rows, with no value read."""
    e, n = 5000, 800
    with rl.CountingMode() as cm:
        adj = edge_adjacency(meta(e, dtype=torch.int32),
                             meta(e, dtype=torch.int32),
                             meta(e, dtype=torch.bool), n)
        y = spmm_aggregate(adj.fwd, meta(n, 8), adj.k_max, adj.fwd_ell)
    assert adj.fwd.m == adj.bwd.m == e and adj.fwd.n == n
    assert adj.fwd_ell[0].shape == (n, adj.k_max) and y.shape == (n, 8)
    assert cm.kernels["ell_spmm"]["ops"] == cm.kernels["spmm_residue"]["ops"] \
        == 1


@pytest.mark.parametrize("arch_id", ["gcn-cora", "gin-tu"])
def test_reduced_gnn_step_traces_on_meta(arch_id):
    """The reduced train step on meta tensors, whole: no DataDependentOp;
    each aggregation launch is one op of each kernel (GCN: 2 layers forward
    and backward; GIN: n_layers forward, one fewer backward)."""
    arch = reduce_arch(arch_id)
    shape = next(s for s in arch.shapes if s.kind == "train")
    args, _ = step_arg_specs(arch, shape)
    with rl.CountingMode() as cm:
        cm.hold(args)
        params, _, metrics = make_step(arch, shape)(*args)
    assert metrics["loss"].is_meta
    layers = arch.model_cfg.n_layers
    calls = 2 * layers if arch_id == "gcn-cora" else 2 * layers - 1
    assert {k: v["ops"] for k, v in cm.kernels.items()} \
        == {"ell_spmm": calls, "spmm_residue": calls}
    assert cm.flops > sum(v["flops"] for v in cm.kernels.values()) > 0


@pytest.mark.parametrize("kind", ["none", "scattered", "trailing"])
def test_fixed_size_aggregation_matches_reference(kind):
    """The port's aggregation over the fixed-size CSR against the JAX
    package's ``spmm_aggregate`` (its plain path) over a CSR of the live
    edges: the same row pointers, the same neighbours in each row (the
    reference sorts them by id), sums within 3e-5."""
    pytest.importorskip("jax")
    jcsr = importlib.import_module("repro.core.csr")
    jops = importlib.import_module("repro.kernels.ell_spmm.ops")
    rows, cols, mask = edges(kind, seed=5)
    g = from_edge_tensors(rows, cols, mask, N)
    m = mask.numpy()
    jg = jcsr.from_edges(rows.numpy()[m], cols.numpy()[m], N,
                         symmetrize=False, drop_self_loops=False)
    rp = np.asarray(jg.row_ptr)
    assert np.array_equal(g.row_ptr.numpy(), rp)
    ci, jci = g.col_idx.numpy(), np.asarray(jg.col_idx)
    for v in range(N):
        assert sorted(ci[rp[v]:rp[v + 1]]) == sorted(jci[rp[v]:rp[v + 1]])
    x = np.random.default_rng(6).standard_normal((N, 7)).astype(np.float32)
    want = np.asarray(jops.spmm_aggregate(jg, x, k_max=4, use_pallas=False))
    got = spmm_aggregate(g, torch.from_numpy(x), 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    assert torch.equal(got, spmm_aggregate_ref(g, torch.from_numpy(x), 4))
