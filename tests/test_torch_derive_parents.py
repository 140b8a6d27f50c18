"""The Parents layer (``kernels/derive_parents``) against ``repro.core.msbfs``.

On the CPU ``_derive_parents`` takes the plain version, which must equal
the reference's ``_derive_parents`` bit for bit on a two-ring graph (one
ring unreached from most roots) and a small R-MAT graph, at lane counts
that are and are not multiples of the kernel's 16-lane rows. A rank's block
(``base`` > 0, sentinel pad slots past its last row, roots outside it) must
give the whole graph's rows, on a 1-D partition and, folded by a MIN over
the column blocks, on a 2-D grid. The CUDA tests hold the kernel against
the plain version bit for bit: a hub row of many segments, lane counts of
every narrowed width, unreached vertices, arbitrary depths, blocks; they
need a GPU and skip without one:

  PYTHONPATH=src python -m pytest -q tests/test_torch_derive_parents.py -k cuda
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.core import msbfs as ms
from repro_torch.core.csr import from_edges
from repro_torch.core.dist2d import partition_graph_2d
from repro_torch.core.dist_bfs import partition_graph
from repro_torch.core.hybrid import MAX_TRACE
from repro_torch.graph.generator import rmat_graph
from repro_torch.kernels import common
from repro_torch.kernels.derive_parents.kernel import (MAX_DEPTH, SEG,
                                                       narrow_depths_cuda,
                                                       narrow_stride,
                                                       scan_parents_cuda,
                                                       segment_scratch)
from repro_torch.kernels.derive_parents.ops import derive_parents
from repro_torch.kernels.derive_parents.ref import derive_parents_ref
from repro_torch.obs import spans

LANES = [1, 8, 13, 64]


def two_rings(n1=40, n2=9):
    """A ring of n1 vertices and a ring of n2 more: a root on one leaves
    the other unreached."""
    a = np.arange(n1)
    b = n1 + np.arange(n2)
    src = np.concatenate([a, b])
    dst = np.concatenate([np.roll(a, -1), np.roll(b, -1)])
    return src, dst, n1 + n2


@pytest.fixture(scope="module")
def ref():
    """The reference's ``_derive_parents`` on a port graph's arrays."""
    pytest.importorskip("jax")
    jnp = importlib.import_module("jax.numpy")
    jcsr = importlib.import_module("repro.core.csr")
    jms = importlib.import_module("repro.core.msbfs")

    def derive(g, depth, roots):
        jg = jcsr.CSRGraph(*(jnp.asarray(t.numpy()) for t in g))
        return np.asarray(jms._derive_parents(
            jg, jnp.asarray(depth.numpy()), jnp.asarray(roots)))
    return SimpleNamespace(derive=derive)


def graph(kind, device="cpu"):
    if kind == "rings":
        src, dst, n = two_rings()
        return from_edges(src, dst, n, device=device)
    return rmat_graph(8, 8, seed=4, device=device)


def roots_for(n, r, seed):
    return np.random.default_rng(seed).choice(n, size=r, replace=r > n
                                              ).astype(np.int32)


def depths(g, roots):
    """The port's depths [n, R] for ``roots`` (R <= 64), on the CPU."""
    return ms.msbfs(g, roots).depth


def hub_graph(device="cpu", hub_deg=3 * SEG + 17, n=4 * SEG, seed=0):
    """Vertex 0 joined to hub_deg others, plus random edges: row 0 has
    more slots than several segments."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(hub_deg, np.int64),
                          rng.integers(1, n, 3 * n)])
    dst = np.concatenate([rng.choice(np.arange(1, n), hub_deg,
                                     replace=False),
                          rng.integers(1, n, 3 * n)])
    return from_edges(src, dst, n, device=device)


@pytest.mark.parametrize("r", LANES)
@pytest.mark.parametrize("kind", ["rings", "rmat"])
def test_plain_matches_reference(ref, kind, r):
    g = graph(kind)
    roots = roots_for(g.n, r, seed=r)
    depth = depths(g, roots)
    got = ms._derive_parents(g, depth, roots)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.derive(g, depth, roots))
    if kind == "rings":
        assert (got == -1).any()  # the other ring's vertices


def test_plain_with_a_hub_row_matches_reference(ref):
    g = hub_graph()
    roots = roots_for(g.n, 13, seed=2)
    depth = depths(g, roots)
    np.testing.assert_array_equal(ms._derive_parents(g, depth, roots).numpy(),
                                  ref.derive(g, depth, roots))


def padded_depth(depth, n):
    """``depth`` [n_orig, R] with -1 rows up to a partition's padded n."""
    out = torch.full((n, depth.shape[1]), -1, dtype=torch.int32,
                     device=depth.device)
    out[:depth.shape[0]] = depth
    return out


@pytest.mark.parametrize("ndev", [2, 4])
def test_a_block_gives_the_whole_graphs_rows(ndev):
    g = graph("rmat")
    roots = roots_for(g.n, 13, seed=ndev)
    whole = ms._derive_parents(g, depths(g, roots), roots)
    dg = partition_graph(g, ndev)
    assert dg.m_loc > min(int(dg.row_ptr[d, -1]) for d in range(ndev))
    depth = padded_depth(depths(g, roots), dg.n)
    for d in range(ndev):
        blk = dg.local(d, "cpu")
        assert blk.base == d * dg.n_loc
        got = ms._derive_parents(blk.g, depth, roots, blk.base)
        want = torch.full((dg.n_loc, len(roots)), -1, dtype=torch.int32)
        rows = whole[blk.base:blk.base + dg.n_loc]
        want[:rows.shape[0]] = rows
        # pad rows past n_orig have no neighbour and no root
        assert torch.equal(got, want), f"block {d}"


def grid_fold(dg, depth, roots, device="cpu"):
    """Each 2-D block's parents, the MIN over each grid row's column
    blocks (-1 losing), rows in order: ``dist2d._derive_parents_2d`` on
    one process."""
    n = dg.n
    out = []
    for i in range(dg.pr):
        acc = None
        for j in range(dg.pc):
            blk = dg.local(i * dg.pc + j, device)
            g = blk.g._replace(col_idx=blk.col_gid)
            part = ms._derive_parents(g, depth, roots, blk.base)
            part = torch.where(part < 0, n, part)
            acc = part if acc is None else torch.minimum(acc, part)
        out.append(torch.where(acc < n, acc, -1))
    return torch.cat(out)


@pytest.mark.parametrize("grid", [(2, 2), (1, 4), (4, 1)])
def test_grid_blocks_fold_to_the_whole_graphs_rows(grid):
    g = graph("rmat")
    roots = roots_for(g.n, 8, seed=sum(grid))
    whole = ms._derive_parents(g, depths(g, roots), roots)
    dg = partition_graph_2d(g, *grid)
    depth = padded_depth(depths(g, roots), dg.n)
    got = grid_fold(dg, depth, roots)
    assert torch.equal(got[:g.n], whole)
    assert (got[g.n:] == -1).all()


def test_spans_and_no_launch_on_the_cpu():
    g = graph("rmat")
    roots = roots_for(g.n, 8, seed=3)
    depth = depths(g, roots)
    before = dict(common.LAUNCHES)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.sweep("test.parents"):
            ms._derive_parents(g, depth, roots)
    assert common.LAUNCHES == before
    names = [s.name for s in spans.recent(1)[0].spans]
    assert names[names.index("msbfs.parents") + 1:] == ["parents.scan",
                                                        "parents.seat"]


def test_narrowed_widths_and_scratch():
    assert [narrow_stride(r) for r in (0, 1, 13, 16, 17, 32, 33, 64, 65, 128,
                                       129, 300)] == [
        16, 16, 16, 16, 32, 32, 64, 64, 128, 128, 256, 384]
    # every depth an engine writes fits a byte beside -1 and the no-target
    assert MAX_TRACE <= MAX_DEPTH < 254
    for m in (0, 1, SEG, 10 * SEG + 3):
        segments, nbytes = segment_scratch(m)
        assert segments * SEG > m and nbytes == 8 * (segments + 1)
    g = hub_graph()
    deg = g.deg.numpy()
    listed = int(np.maximum(-(-deg // SEG) - 1, 0).sum())
    assert 0 < listed <= segment_scratch(g.m)[0]


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        narrow_depths_cuda(x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scan_parents_cuda(torch.zeros(3, dtype=torch.int32),
                          torch.zeros(2, dtype=torch.int32),
                          torch.zeros((4, 16), dtype=torch.uint8), 3)
    with pytest.raises(ValueError, match="no derive_parents"):
        derive_parents(x[0], x[0], x[0], x.to("meta"))


# ---------------------------------------------------------------------------
# On the card: the kernel against the plain version, bit for bit
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def kernel_vs_plain(g, depth, base=0):
    """(kernel, plain) parents of ``g``'s rows; ``g`` on the CPU."""
    dev = torch.device("cuda")
    before = common.LAUNCHES["derive_parents"]
    got = derive_parents(*(t.to(dev) for t in g), depth.to(dev), base)
    torch.cuda.synchronize()
    assert common.LAUNCHES["derive_parents"] == before + 2
    want = derive_parents_ref(*g, depth, base)
    return got.cpu(), want


@pytest.mark.parametrize("r", [1, 13, 16, 17, 40, 64, 100, 200])
def test_cuda_matches_plain_with_a_hub_row(cuda_device, r):
    g = hub_graph(seed=r)
    assert int(g.deg[0]) > 3 * SEG
    roots = roots_for(g.n, min(r, 64), seed=r)
    depth = depths(g, roots)
    if r > 64:  # more lanes than a batch: the columns again
        depth = depth.repeat(1, -(-r // 64))[:, :r].contiguous()
    got, want = kernel_vs_plain(g, depth)
    assert torch.equal(got, want)


@pytest.mark.parametrize("r", [8, 13, 64])
def test_cuda_matches_plain_with_unreached_vertices(cuda_device, r):
    g = graph("rings")
    roots = roots_for(40, r, seed=r)  # all on the first ring
    depth = depths(g, roots)
    got, want = kernel_vs_plain(g, depth)
    assert torch.equal(got, want) and (got[40:] == -1).all()


@pytest.mark.parametrize("r", [5, 64, 130])
def test_cuda_matches_plain_on_arbitrary_depths(cuda_device, r):
    g = hub_graph(seed=7)
    rng = np.random.default_rng(r)
    depth = torch.from_numpy(rng.integers(-1, 6, (g.n, r)).astype(np.int32))
    depth[rng.random((g.n, r)) < 0.01] = MAX_DEPTH
    got, want = kernel_vs_plain(g, depth)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ndev", [2, 4])
def test_cuda_blocks_match_plain(cuda_device, ndev):
    g = graph("rmat")
    roots = roots_for(g.n, 13, seed=ndev)
    dg = partition_graph(g, ndev)
    depth = padded_depth(depths(g, roots), dg.n)
    for d in range(ndev):
        blk = dg.local(d, "cpu")
        got, want = kernel_vs_plain(blk.g, depth, blk.base)
        assert torch.equal(got, want), f"block {d}"
    dg2 = partition_graph_2d(g, 2, 2)
    depth2 = padded_depth(depths(g, roots), dg2.n)
    got = grid_fold(dg2, depth2.to(cuda_device), roots, cuda_device)
    assert torch.equal(got.cpu(), grid_fold(dg2, depth2, roots))


def test_cuda_msbfs_parents_match_the_cpu(cuda_device):
    g = graph("rmat")
    roots = roots_for(g.n, 64, seed=9)
    want = ms.msbfs(g, roots)
    got = ms.msbfs(graph("rmat", cuda_device), roots)
    assert torch.equal(got.depth.cpu(), want.depth)
    assert torch.equal(got.parent.cpu(), want.parent)


def test_cuda_wrapper_raises_on_what_it_cannot_take(cuda_device):
    g = hub_graph(device=cuda_device)
    depth = torch.zeros((g.n, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        derive_parents(*g, depth.long())
    with pytest.raises(ValueError, match="contiguous"):
        derive_parents(*g, torch.zeros((g.n, 16), dtype=torch.int32,
                                       device=cuda_device)[:, ::2])
    narrow = narrow_depths_cuda(depth)
    with pytest.raises(ValueError, match="bytes a row"):
        scan_parents_cuda(g.row_ptr, g.col_idx, narrow, 20)
    with pytest.raises(ValueError, match="must lie in"):
        scan_parents_cuda(g.row_ptr, g.col_idx, narrow, 8, base=1)
