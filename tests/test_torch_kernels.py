"""The port's kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take the kernels' plain PyTorch versions;
the Pallas kernels run in interpret mode, as the JAX package's own tests run
them. Outputs are integer arrays, or float32 minima of the same sums, so
the tolerance is exact equality. The
tests that launch the CUDA kernels need a GPU and skip without one; they
use neither JAX nor the JAX package, so they also run on a machine that has
a GPU and no JAX:

  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py -k cuda
"""
import importlib
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (effective_cfg, make_step,
                                      param_builders)
from repro_torch.configs.reduced import reduce_arch
from repro_torch.core import bitmap
from repro_torch.core.csr import (ell_pad, from_numpy_graph,
                                  from_weighted_edges)
from repro_torch.core.hybrid import bfs
from repro_torch.core.msbfs import msbfs_pipelined
from repro_torch.core.topdown import topdown_step
from repro_torch.graph.generator import (rmat_graph, rmat_weighted_graph,
                                         sample_roots)
from repro_torch.kernels import common
from repro_torch.kernels.bottom_up_probe.kernel import bottom_up_probe_cuda
from repro_torch.kernels.bottom_up_probe.ops import bottom_up_probe
from repro_torch.kernels.bottom_up_probe.ref import bottom_up_probe_ref
from repro_torch.kernels.ell_spmm.kernel import ell_spmm_cuda
from repro_torch.kernels.ell_spmm.ops import spmm_aggregate
from repro_torch.kernels.ell_spmm.ref import ell_spmm_ref
from repro_torch.kernels.msbfs_probe.kernel import msbfs_probe_cuda
from repro_torch.kernels.msbfs_probe.ops import msbfs_probe
from repro_torch.kernels.msbfs_probe.ref import msbfs_probe_ref
from repro_torch.kernels.relax_fallback.kernel import relax_fallback_cuda
from repro_torch.kernels.relax_fallback.ops import relax_fallback
from repro_torch.kernels.relax_fallback.ref import relax_fallback_ref
from repro_torch.kernels.segment_or.kernel import (SEG as OR_SEG,
                                                  segment_or_rows_cuda,
                                                  segment_scratch)
from repro_torch.kernels.segment_or.ops import segment_or_rows
from repro_torch.kernels.segment_or.ref import segment_or_rows_ref
from repro_torch.kernels.semiring_relax.kernel import semiring_relax_cuda
from repro_torch.kernels.semiring_relax.ops import semiring_relax
from repro_torch.kernels.semiring_relax.ref import semiring_relax_ref
from repro_torch.kernels.spmm_residue.kernel import (SEG, residue_launches,
                                                     residue_scratch,
                                                     spmm_residue_cuda)
from repro_torch.kernels.spmm_residue.ref import spmm_residue_ref
from repro_torch.kernels.topdown_scan.kernel import (frontier_scratch,
                                                    topdown_scan_cuda)
from repro_torch.kernels.topdown_scan.ops import topdown_scan
from repro_torch.kernels.topdown_scan.ref import (topdown_best_ref,
                                                  topdown_scan_ref)
from repro_torch.models.gnn.common import (build_adjacency,
                                           synthetic_graph_batch)
from repro_torch.optim.adamw import init_opt_state
from repro_torch.traversal.sssp import sssp_pipelined


@pytest.fixture(scope="module")
def ref():
    """The JAX package's pieces these tests hold the port against."""
    pytest.importorskip("jax")
    mod = importlib.import_module
    kernels = mod("repro.kernels")
    gen = mod("repro.graph.generator")
    return SimpleNamespace(
        jnp=mod("jax.numpy"), bitmap=mod("repro.core.bitmap"),
        rmat=gen.rmat_graph, uniform=gen.uniform_random_graph,
        probe_pallas=kernels.bottom_up_probe_pallas,
        scan_pallas=kernels.topdown_scan_pallas,
        step_pallas=kernels.topdown_step_pallas)


def port_graph(jg, device="cpu"):
    """The JAX package's graph, carried into the port unchanged."""
    return from_numpy_graph(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                            np.asarray(jg.src_idx), device)


def split(n, seed):
    """The seeded visited/frontier split of tests/test_kernels.py."""
    rng = np.random.default_rng(seed)
    vis = rng.random(n) < 0.4
    fro = (rng.random(n) < 0.25) & ~vis
    return vis, fro


def lane_split(n, w, seed, device="cpu"):
    """Seeded random lane words int32[n, w]: (frontier, visited)."""
    rng = np.random.default_rng(seed)

    def words():
        return torch.from_numpy(rng.integers(0, 2 ** 32, (n, w),
                                             dtype=np.uint32).view(np.int32))
    vis = words() & words()
    return (words() & ~vis).to(device), vis.to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("scale,ef,seed", [(8, 4, 0), (9, 8, 1), (10, 16, 2),
                                           (7, 32, 3)])
@pytest.mark.parametrize("max_pos", [1, 8])
def test_bottom_up_probe_plain_matches_pallas(ref, scale, ef, seed, max_pos):
    jnp = ref.jnp
    jg = ref.rmat(scale, ef, seed=seed)
    g = port_graph(jg)
    vis, fro = split(jg.n, seed)
    jfw = ref.bitmap.pack(jnp.asarray(fro))
    par = np.full(jg.n, -1, np.int32)
    f1, p1 = ref.probe_pallas(jg.row_ptr[:-1], jg.deg, jnp.asarray(~vis),
                              jnp.asarray(par), jg.col_idx, jfw,
                              max_pos=max_pos, interpret=True)
    fw = bitmap.pack(torch.from_numpy(fro))
    f2, p2 = bottom_up_probe_ref(g.row_ptr[:-1], g.deg,
                                 torch.from_numpy(~vis).to(torch.int32),
                                 torch.from_numpy(par), g.col_idx, fw,
                                 max_pos=max_pos)
    assert f2.dtype == torch.int32 and p2.dtype == torch.int32
    np.testing.assert_array_equal(f2.numpy(), np.asarray(f1))
    np.testing.assert_array_equal(p2.numpy(), np.asarray(p1))
    # the wrapper the BFS step calls: CPU tensors take the plain version
    f3, p3 = bottom_up_probe(g.row_ptr, g.col_idx, fw,
                             torch.from_numpy(~vis), torch.from_numpy(par),
                             max_pos)
    assert f3.dtype == torch.bool
    np.testing.assert_array_equal(f3.numpy(), np.asarray(f1) != 0)
    np.testing.assert_array_equal(p3.numpy(), np.asarray(p1))


@pytest.mark.parametrize("n,m,seed", [(300, 1200, 0), (1024, 8000, 1),
                                      (77, 300, 2)])
def test_topdown_scan_plain_matches_pallas(ref, n, m, seed):
    jnp = ref.jnp
    jg = ref.uniform(n, m, seed=seed)
    g = port_graph(jg)
    vis, fro = split(jg.n, seed)
    jfw = ref.bitmap.pack(jnp.asarray(fro))
    jvw = ref.bitmap.pack(jnp.asarray(vis))
    c1 = ref.scan_pallas(jg.src_idx, jg.col_idx, jfw, jvw, jg.n,
                         interpret=True)
    fw, vw = bitmap.pack(torch.from_numpy(fro)), bitmap.pack(
        torch.from_numpy(vis))
    c2 = topdown_scan_ref(g.src_idx, g.col_idx, fw, vw, g.n)
    assert c2.dtype == torch.int32
    np.testing.assert_array_equal(c2.numpy(), np.asarray(c1))
    # the fused kernel's plain version is that scan plus the scatter-min
    best = np.full(jg.n, jg.n, np.int64)
    np.minimum.at(best, np.asarray(jg.col_idx), np.asarray(c1))
    np.testing.assert_array_equal(
        topdown_best_ref(g.src_idx, g.col_idx, fw, vw, g.n).numpy(), best)
    np.testing.assert_array_equal(
        topdown_scan(g.row_ptr, g.col_idx, fw, vw, g.n).numpy(),
        best)


@pytest.mark.parametrize("n,m,seed", [(300, 1200, 0), (1024, 8000, 1),
                                      (77, 300, 2)])
def test_topdown_step_matches_pallas_step(ref, n, m, seed):
    jnp = ref.jnp
    jg = ref.uniform(n, m, seed=seed)
    g = port_graph(jg)
    vis, fro = split(jg.n, seed)
    vis |= fro  # visited includes the frontier, as in a BFS
    par = np.where(vis, np.arange(jg.n), -1).astype(np.int32)
    out_j = ref.step_pallas(jg, jnp.asarray(fro), jnp.asarray(vis),
                            jnp.asarray(par))
    out_t = topdown_step(g, torch.from_numpy(fro), torch.from_numpy(vis),
                         torch.from_numpy(par))
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_cpu_path_launches_no_kernel():
    g = rmat_graph(7, 8, seed=5, device="cpu")
    vis, fro = split(g.n, 5)
    before = dict(common.LAUNCHES)
    fw = bitmap.pack(torch.from_numpy(fro))
    bottom_up_probe(g.row_ptr, g.col_idx, fw, torch.from_numpy(~vis),
                    torch.full((g.n,), -1, dtype=torch.int32), 8)
    topdown_scan(g.row_ptr, g.col_idx, fw, bitmap.pack(torch.from_numpy(vis)),
                 g.n)
    fro_w, vis_w = lane_split(g.n, 2, 5)
    msbfs_probe(g.row_ptr, g.col_idx, fro_w, ~vis_w, 8)
    segment_or_rows(g.row_ptr, g.col_idx, fro_w, ~vis_w)
    w = torch.ones(g.m)
    vals = torch.zeros((g.n, 3))
    acc = semiring_relax(g.row_ptr, g.col_idx, w, vals, 8)
    relax_fallback(g.row_ptr, g.src_idx, g.col_idx, w, vals, acc, 8)
    spmm_aggregate(g, torch.ones((g.n, 4)), 8)
    assert common.LAUNCHES == before


def test_cuda_wrappers_refuse_cpu_tensors():
    """A kernel wrapper never falls back: CPU tensors are refused before
    anything is built or launched."""
    x = torch.zeros(4, dtype=torch.int32)
    row_ptr = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bottom_up_probe_cuda(row_ptr, x.bool(), x, x, x, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        topdown_scan_cuda(torch.zeros(5, dtype=torch.int32), x, x, x, 4)
    words = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        msbfs_probe_cuda(row_ptr, words, x, words, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_or_rows_cuda(torch.zeros(5, dtype=torch.int32), x, words,
                             words)
    w, vals = torch.zeros(4), torch.zeros((4, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        semiring_relax_cuda(torch.zeros(5, dtype=torch.int32), x, w, vals, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        relax_fallback_cuda(torch.zeros(5, dtype=torch.int32), x, x, w, vals,
                            vals, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ell_spmm_cuda(words, torch.zeros((4, 2), dtype=torch.bool), vals)
    with pytest.raises(ValueError, match="CUDA tensor"):
        spmm_residue_cuda(torch.zeros(5, dtype=torch.int32), x, x, vals, vals,
                          8)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(common.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        common.build_kernels()
    assert not (tmp_path / "build").exists()


def test_build_sources_and_flags():
    names = sorted(p.name for p in common.CSRC_DIR.glob("*.cu"))
    assert names == ["bottom_up_probe.cu", "derive_parents.cu", "ell_spmm.cu",
                     "msbfs_probe.cu", "relax_fallback.cu", "segment_or.cu",
                     "semiring_relax.cu", "spmm_residue.cu", "topdown_scan.cu"]
    assert set(common.LAUNCHES) == {p[:-3] for p in names}
    assert "arch=compute_90a,code=sm_90a" in common.NVCC_FLAGS
    assert common.cdiv(33, 32) == 2 and common.cdiv(64, 32) == 2


@pytest.mark.parametrize("max_pos", [1, 8, 16, 32, 33])
def test_bottom_up_probe_cuda_matches_plain(cuda_device, max_pos):
    g = rmat_graph(12, 16, seed=max_pos, device=cuda_device)
    vis, fro = split(g.n, max_pos)
    fw = bitmap.pack(torch.from_numpy(fro).to(cuda_device))
    unv = torch.from_numpy(~vis).to(cuda_device)
    par = torch.full((g.n,), -1, dtype=torch.int32, device=cuda_device)
    before = common.LAUNCHES["bottom_up_probe"]
    k = bottom_up_probe_cuda(g.row_ptr, unv, par, g.col_idx, fw, max_pos)
    torch.cuda.synchronize()
    assert common.LAUNCHES["bottom_up_probe"] == before + 1
    want = bottom_up_probe_ref(g.row_ptr[:-1], g.deg, unv.to(torch.int32),
                               par, g.col_idx, fw, max_pos)
    for a, b in zip(k, want):
        assert torch.equal(a, b)


def probe_rows_graph(n=300, seed=0):
    """A CSR with the rows the bottom-up probe has to get right, ids drawn
    outside the frontier F (the even ids below n) unless placed: a hub
    (row 0, 2000 slots, first frontier neighbour at position 20), rows of
    degree 0 (1-5), a first hit at position 7 (row 6) and at 8 (row 7),
    ids at or past 32 x num_words before a hit at 5 (row 8), an unsorted
    row whose first hit (position 0) is not its lowest frontier id (row 9),
    a frontier neighbour past position 33 only (row 10); the rest random.
    Returns (row_ptr, col_idx, frontier bool[n], the pinned first hits
    {row: (position, id)})."""
    rng = np.random.default_rng(seed)
    fro = np.arange(n) % 2 == 0
    odd = np.arange(1, n, 2)
    words = -(-n // 32)
    rows = [rng.choice(odd, 2000)] + [np.zeros(0, np.int64)] * 5
    pinned = {0: (20, 40), 6: (7, 42), 7: (8, 44), 8: (5, 46), 9: (0, 98)}
    for v, size in ((6, 12), (7, 12), (8, 9), (9, 6), (10, 40)):
        rows.append(rng.choice(odd, size))
    rows[0][20] = 40
    rows[6][[7, 9]] = [42, 2]
    rows[7][8] = 44
    rows[8][:4] = 32 * words + np.array([0, 1, 31, 64])
    rows[8][5] = 46
    rows[9][[0, 3]] = [98, 4]  # sorted, the first hit would be 4
    rows[10][35] = 48
    for _ in range(11, n):
        rows.append(rng.integers(0, n, rng.integers(0, 30)))
    row_ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    return row_ptr, np.concatenate(rows), fro, pinned


@pytest.mark.parametrize("visited", ["some", "none", "all"])
@pytest.mark.parametrize("max_pos", [1, 8, 16, 33])
def test_bottom_up_probe_cuda_probe_rows(cuda_device, visited, max_pos):
    """The probe, bit-equal to its plain version on probe_rows_graph's
    rows, and each pinned row's parent is its first hit by position."""
    row_ptr, col_idx, fro, pinned = probe_rows_graph()
    n = fro.size
    g = from_numpy_graph(row_ptr, col_idx, np.repeat(np.arange(n),
                                                     np.diff(row_ptr)),
                         cuda_device)
    fw = bitmap.pack(torch.from_numpy(fro).to(cuda_device))
    rng = np.random.default_rng(max_pos)
    vis = {"some": rng.random(n) < 0.4, "none": np.zeros(n, bool),
           "all": np.ones(n, bool)}[visited]
    vis[list(pinned) + [10]] = visited == "all"
    unv = torch.from_numpy(~vis).to(cuda_device)
    par = torch.from_numpy(rng.integers(-1, n, n).astype(np.int32)).to(
        cuda_device)
    before = common.LAUNCHES["bottom_up_probe"]
    found, got = bottom_up_probe_cuda(g.row_ptr, unv, par, g.col_idx, fw,
                                      max_pos)
    torch.cuda.synchronize()
    assert common.LAUNCHES["bottom_up_probe"] == before + 1
    want = bottom_up_probe_ref(g.row_ptr[:-1], g.deg, unv.to(torch.int32),
                               par, g.col_idx, fw, max_pos)
    assert torch.equal(found, want[0]) and torch.equal(got, want[1])
    found, got, par = found.cpu().numpy(), got.cpu().numpy(), par.cpu()
    for v, (pos, u) in pinned.items():
        hit = visited != "all" and pos < max_pos
        assert found[v] == hit and got[v] == (u if hit else int(par[v]))
    assert found[10] == 0 and not found[1:6].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_topdown_scan_cuda_matches_plain(cuda_device, seed):
    g = rmat_graph(12, 16, seed=seed, device=cuda_device)
    vis, fro = split(g.n, seed)
    fw = bitmap.pack(torch.from_numpy(fro).to(cuda_device))
    vw = bitmap.pack(torch.from_numpy(vis).to(cuda_device))
    before = common.LAUNCHES["topdown_scan"]
    k = topdown_scan_cuda(g.row_ptr, g.col_idx, fw, vw, g.n)
    torch.cuda.synchronize()
    assert common.LAUNCHES["topdown_scan"] == before + 1
    assert torch.equal(k, topdown_best_ref(g.src_idx, g.col_idx, fw, vw,
                                           g.n))


def split_row_graph(device, n=2000, seed=0, extra_ids=0):
    """A CSR with every kind of row the row-OR and the top-down scan sort
    their work by: a hub over several segments, rows of exactly OR_SEG and
    OR_SEG + 1 slots and of 31, 32 and 33 (the bound of a warp's list),
    short and empty rows; neighbour ids in [0, n + extra_ids)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 40, n)
    deg[rng.random(n) < 0.2] = 0
    deg[0] = 5 * OR_SEG + 7
    for i, d in enumerate([OR_SEG, OR_SEG + 1, 31, 32, 33, 2 * OR_SEG, 7, 8,
                           9]):
        deg[3 + 11 * i] = d
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    col_idx = rng.integers(0, n + extra_ids, int(row_ptr[-1]))
    return from_numpy_graph(row_ptr, col_idx, np.repeat(np.arange(n), deg),
                            device)


def segments_needed(deg, min_pos=0):
    """The long-row segments of the row-OR, counted with numpy."""
    cnt = np.maximum(np.asarray(deg) - min_pos, 0)
    long = cnt[cnt > OR_SEG]
    return int(np.sum(-(-long // OR_SEG)))


@pytest.mark.parametrize("case", ["hub", "all_long", "just_over", "rmat"])
@pytest.mark.parametrize("min_pos", [0, 8])
def test_segment_scratch_bound(case, min_pos):
    """The row-OR's segment list holds every long row's segments, however
    the slots are spread over rows."""
    if case == "rmat":
        deg = rmat_graph(10, 16, seed=1, device="cpu").deg.numpy()
    else:
        d = {"hub": 40 * OR_SEG + 3, "all_long": 3 * OR_SEG,
             "just_over": OR_SEG + 1}[case]
        deg = np.full(1 if case == "hub" else 50, d)
    segments, nbytes = segment_scratch(int(deg.sum()))
    assert segments_needed(deg, min_pos) <= segments
    assert nbytes == 8 + 8 * segments
    assert segment_scratch(0) == (1, 16)


@pytest.mark.parametrize("n", [0, 1, 33, 2 ** 20])
def test_frontier_scratch_bytes(n):
    """The top-down scan's list has one (vertex, row start, offset) entry
    per frontier vertex at most, after its 8-byte counter."""
    assert frontier_scratch(n) == 8 + 3 * 4 * n


def edgeless_graph(device, n=70):
    return from_numpy_graph(np.zeros(n + 1), np.zeros(0), np.zeros(0), device)


@pytest.mark.parametrize("w", [1, 2, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("form", ["topdown", "fallback", "sparse_active",
                                  "edgeless"])
def test_segment_or_cuda_split_rows(cuda_device, w, form):
    """The row-OR, bit-equal to its plain version on rows the design sorts
    into a warp's list, a warp's walk and segments: a hub over five
    segments, rows of exactly one segment and one slot more, min_pos
    above some rows' degrees, a frontier of more rows than the graph; and
    on a graph with no edges."""
    g = (edgeless_graph(cuda_device) if form == "edgeless"
         else split_row_graph(cuda_device, seed=w))
    fro, vis = lane_split(g.n + 37, w, w, cuda_device)
    mask = ~vis[:g.n]
    rng = np.random.default_rng(w)
    sel = torch.from_numpy(rng.integers(0, 2 ** 32, w, dtype=np.uint32)
                           .view(np.int32)).to(cuda_device)
    base = lane_split(g.n, w, w + 1, cuda_device)[0]
    active = torch.from_numpy((rng.random(g.n) < (
        0.05 if form == "sparse_active" else 0.6)).astype(np.int32))
    active[[0, 3, 14]] = 1  # the hub, the rows of OR_SEG and OR_SEG + 1
    active = active.to(cuda_device)
    call = {"topdown": (mask, sel, None, None, 0),
            "fallback": (mask, None, base, active, 8),
            "sparse_active": (mask, sel, base, active, 33),
            "edgeless": (mask, sel, base, active, 0)}[form]
    args = (g.row_ptr, g.col_idx, fro) + call
    before = common.LAUNCHES["segment_or"]
    got = segment_or_rows_cuda(*args)
    torch.cuda.synchronize()
    assert common.LAUNCHES["segment_or"] == before + 1
    assert torch.equal(got, segment_or_rows_ref(*args))


@pytest.mark.parametrize("case", ["hub", "empty", "full", "padding_bits",
                                  "ids_past_n", "random", "edgeless"])
def test_topdown_scan_cuda_frontier_cases(cuda_device, case):
    """The top-down scan, equal to its plain version on frontiers that
    hold the largest row (split over many warps' chunks), nothing, every
    vertex, set bits past n in the last word, and neighbour ids >= n
    (skipped: the plain version runs on the slots that remain); and on a
    graph with no edges."""
    g = (edgeless_graph(cuda_device) if case == "edgeless"
         else split_row_graph(cuda_device, seed=5,
                              extra_ids=50 if case == "ids_past_n" else 0))
    n = g.n
    rng = np.random.default_rng(5)
    vis = torch.from_numpy(rng.random(n) < 0.3).to(cuda_device)
    fro = torch.from_numpy(rng.random(n) < 0.2).to(cuda_device) & ~vis
    if case == "hub":
        fro = torch.zeros_like(fro)
        fro[int(torch.argmax(g.deg))] = True
        vis = vis | fro
    elif case == "empty":
        fro = torch.zeros_like(fro)
    elif case == "full":
        fro, vis = torch.ones_like(fro), torch.zeros_like(vis)
    fw, vw = bitmap.pack(fro), bitmap.pack(vis)
    if case == "padding_bits":
        assert n % 32
        fw[-1] |= torch.tensor(-1 << (n % 32), dtype=torch.int32,
                               device=cuda_device)
    keep = g.col_idx < n
    want = topdown_best_ref(g.src_idx[keep], g.col_idx[keep], fw, vw, n)
    before = common.LAUNCHES["topdown_scan"]
    got = topdown_scan_cuda(g.row_ptr, g.col_idx, fw, vw, n)
    torch.cuda.synchronize()
    assert common.LAUNCHES["topdown_scan"] == before + 1
    assert torch.equal(got, want)
    if case in ("empty", "edgeless"):
        assert bool((got == n).all())


@pytest.mark.parametrize("mode", ["hybrid", "topdown", "bottomup_simd",
                                  "bottomup_nosimd", "hybrid_nosimd"])
def test_bfs_on_gpu_matches_cpu(cuda_device, mode):
    """The whole slice on the card: every BFSResult field equals the CPU
    run's, and the kernels the mode needs were launched."""
    g_cpu = rmat_graph(12, 16, seed=7, device="cpu")
    g_gpu = rmat_graph(12, 16, seed=7, device=cuda_device)
    common.reset_launches()
    for root in sample_roots(g_cpu, 2, seed=8):
        want = bfs(g_cpu, int(root), mode)
        got = bfs(g_gpu, int(root), mode)
        for name, a, b in zip(want._fields, got, want):
            assert torch.equal(a.cpu(), b), name
    if mode in ("hybrid", "topdown", "hybrid_nosimd"):
        assert common.LAUNCHES["topdown_scan"] > 0
    if mode in ("hybrid", "bottomup_simd"):
        assert common.LAUNCHES["bottom_up_probe"] > 0


@pytest.mark.parametrize("w", [1, 2, 3, 8, 9, 16])
def test_lane_kernels_cuda_match_plain(cuda_device, w):
    """msbfs_probe (raw acc) and both forms of the row-OR, bit-equal to
    their plain versions, with a frontier of more rows than the graph."""
    g = rmat_graph(12, 16, seed=w, device=cuda_device)
    fro, vis = lane_split(g.n + 37, w, w, cuda_device)
    need = ~vis[:g.n]
    before = dict(common.LAUNCHES)
    acc = msbfs_probe_cuda(g.row_ptr, need, g.col_idx, fro, 8)
    assert torch.equal(acc, msbfs_probe_ref(g.row_ptr[:-1], g.deg, need,
                                            g.col_idx, fro, 8))
    found = acc & need
    residue = ((need & ~found) != 0).any(dim=-1) & (g.deg > 8)
    sel = torch.from_numpy(np.array([-1, 0x5555AAAA] * w, np.int64)[:w]
                           .astype(np.int32)).to(cuda_device)
    for form in [(need, None, found, residue.to(torch.int32), 8),
                 (~vis[:g.n], sel, None, None, 0)]:
        call = (g.row_ptr, g.col_idx, fro) + form
        assert torch.equal(segment_or_rows_cuda(*call),
                           segment_or_rows_ref(*call))
    torch.cuda.synchronize()
    assert common.LAUNCHES["msbfs_probe"] == before["msbfs_probe"] + 1
    assert common.LAUNCHES["segment_or"] == before["segment_or"] + 2


def lane_probe_rows(n, nf, w, seed):
    """Rows and lane words the lane-word probe has to get right: a hub
    (row 0, 600 slots), rows of degree 0 (1-3), ids at or past nf and
    negative ones (row 4), need rows of zeros (5-7, and a fifth of the
    rest), and row 8, whose plane 0 retires at position 2 while its last
    plane stays live to position 9 (a later gather past retirement would
    change plane 0's raw acc). Returns (row_ptr, col_idx, frontier int32[nf,
    w], need int32[n, w])."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, nf, 600)] + [np.zeros(0, np.int64)] * 3
    rows.append(np.array([nf, -1, 3, nf + 5, 4, 2 ** 31 - 1, 6]))
    rows += [rng.integers(0, nf, 12) for _ in range(4)]
    rows[8] = np.arange(10, 22)  # frontier rows 10..21, set below
    for _ in range(9, n):
        rows.append(rng.integers(0, nf, rng.integers(0, 40)))
    row_ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    words = rng.integers(0, 2 ** 32, (2, nf, w), dtype=np.uint32)
    fro = words[0] & words[1]
    need = rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32)
    need[rng.random(n) < 0.2] = 0
    need[5:8] = 0
    need[8] = 1
    fro[10:22] = 0
    fro[12, 0] = 1  # plane 0 retires at position 2
    fro[13:22, 0] = 0xF0
    fro[19, w - 1] = 1  # the last plane retires at position 9
    fro[20:22, w - 1] = 0xF00
    return (row_ptr, np.concatenate(rows), fro.view(np.int32),
            need.view(np.int32))


@pytest.mark.parametrize("w", [1, 2, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("max_pos", [1, 8, 16, 33])
def test_msbfs_probe_cuda_probe_rows(cuda_device, w, max_pos):
    """The lane-word probe, bit-equal to its plain version (raw acc) on
    lane_probe_rows, a frontier of more rows than the graph; and row 8's
    planes retire where the rule says."""
    n = 300
    nf = n + 37
    row_ptr, col_idx, fro, need = lane_probe_rows(n, nf, w, w * 100 + max_pos)
    g = from_numpy_graph(row_ptr, col_idx, np.repeat(np.arange(n),
                                                     np.diff(row_ptr)),
                         cuda_device)
    fro_t = torch.from_numpy(fro).to(cuda_device)
    need_t = torch.from_numpy(need).to(cuda_device)
    before = common.LAUNCHES["msbfs_probe"]
    got = msbfs_probe_cuda(g.row_ptr, need_t, g.col_idx, fro_t, max_pos)
    torch.cuda.synchronize()
    assert common.LAUNCHES["msbfs_probe"] == before + 1
    want = msbfs_probe_ref(g.row_ptr[:-1], g.deg, need_t, g.col_idx, fro_t,
                           max_pos)
    assert torch.equal(got, want)
    acc = got.cpu().numpy().view(np.uint32)
    assert not acc[1:4].any() and not acc[5:8].any()
    if max_pos >= 16:
        assert acc[8, 0] == 1 and acc[8, w - 1] == 1


@pytest.mark.parametrize("mode", ["hybrid", "topdown", "bottomup"])
def test_msbfs_pipelined_on_gpu_matches_cpu(cuda_device, mode):
    """The multi-source slice on the card, with lane refills: every
    MSBFSResult field equals the CPU run's."""
    g_cpu = rmat_graph(11, 16, seed=9, device="cpu")
    g_gpu = rmat_graph(11, 16, seed=9, device=cuda_device)
    roots = sample_roots(g_cpu, 80, seed=10)
    common.reset_launches()
    want = msbfs_pipelined(g_cpu, roots, mode, lanes=64)
    got = msbfs_pipelined(g_gpu, roots, mode, lanes=64)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a.cpu(), b), name
    assert common.LAUNCHES["segment_or"] > 0
    if mode != "topdown":
        assert common.LAUNCHES["msbfs_probe"] > 0


INF_SHARE = {"fifth_inf": 0.2, "light": 0.97, "all_inf": 1.0}


def relax_graph(device, max_pos=8, weights="fifth_inf", n=3000, seed=0):
    """A directed weighted CSR with every kind of row the relax kernels
    meet: row 0 a hub over every vertex (one very long row), row 1 exactly
    ``max_pos`` neighbours, row 2 empty, row 3 ``max_pos + 1``, the rest
    0-40 random neighbours; a share of the weights +inf (excluded edges)
    by the engine's masks: about a fifth, all but about 3 % (the light
    relax), or all."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 41, n)
    deg[:4] = (n, max_pos, 0, max_pos + 1)
    src = np.repeat(np.arange(n), deg)
    dst = np.concatenate([np.arange(n), rng.integers(0, n, deg[1:].sum())])
    g = from_weighted_edges(src, dst, rng.uniform(0, 1, src.size), n,
                            symmetrize=False, drop_self_loops=False,
                            device=device)
    w = g.weights.clone()
    w[torch.from_numpy(rng.random(g.m) < INF_SHARE[weights]).to(device)] = (
        float("inf"))
    return g, w


def relax_values(n_rows, lanes, seed, device):
    """Seeded lane values, about three quarters +inf (inactive sources)."""
    rng = np.random.default_rng(seed)
    vals = rng.uniform(0, 4, (n_rows, lanes)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.75] = np.inf
    return torch.from_numpy(vals).to(device)


@pytest.mark.parametrize("weights", list(INF_SHARE))
@pytest.mark.parametrize("lanes", [1, 3, 8, 32, 33, 64])
@pytest.mark.parametrize("max_pos", [1, 8, 9, 40])
def test_relax_kernels_cuda_match_plain(cuda_device, lanes, max_pos,
                                        weights):
    """semiring_relax (a thread per vertex at L <= 8, a warp's probe list
    over 32 vertices above, and the flat form at L = 1) and relax_fallback
    (in place), bit-equal to their plain versions under each weight mask,
    with lane values of more rows than the graph; two launches of
    semiring_relax give the same bits."""
    g, w = relax_graph(cuda_device, max_pos, weights)
    vals = relax_values(g.n + 37, lanes, lanes + max_pos, cuda_device)
    before = dict(common.LAUNCHES)
    want = semiring_relax_ref(g.row_ptr[:-1], g.deg, g.col_idx, w, vals,
                              max_pos)
    got = semiring_relax_cuda(g.row_ptr, g.col_idx, w, vals, max_pos)
    again = semiring_relax_cuda(g.row_ptr, g.col_idx, w, vals, max_pos)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    assert bool(torch.isinf(got).all()) == (weights == "all_inf")
    if lanes == 1:
        flat = semiring_relax_cuda(g.row_ptr, g.col_idx, w,
                                   vals[:, 0].contiguous(), max_pos)
        assert flat.shape == (g.n,) and torch.equal(flat, want[:, 0])
    args = (g.row_ptr, g.src_idx, g.col_idx, w, vals)
    folded = relax_fallback_ref(*args, want.clone(), max_pos)
    base = want.clone()
    assert relax_fallback_cuda(*args, base, max_pos) is base   # in place
    assert torch.equal(base.view(torch.int32), folded.view(torch.int32))
    torch.cuda.synchronize()
    assert common.LAUNCHES["semiring_relax"] == (
        before["semiring_relax"] + 2 + (lanes == 1))
    assert common.LAUNCHES["relax_fallback"] == before["relax_fallback"] + 1
    # the hub row's residue spans many of the fold's 256-slot segments and
    # merges by atomics
    assert int(g.deg[0]) - max_pos > 10 * 256


def test_relax_bound_counts_row_ptr():
    """chip_smoke.py's bound for semiring_relax counts what the kernel
    reads and writes once: row_ptr (n + 1 int32), a weight per probe slot,
    an id per finite one, each gathered lane row, and acc."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n, lanes, slots, finite, rows = 1000, 32, 5000, 300, 200
    nbytes = (4 * (n + 1) + 4 * (slots + finite) + 4 * lanes * rows
              + 4 * n * lanes)
    assert smoke.relax_cost(n, lanes, slots, finite, rows) == (
        smoke.bound_ms(nbytes, 2 * finite * lanes))


@pytest.mark.parametrize("kernel", ["bottom_up_probe", "msbfs_probe"])
def test_probe_bounds_count_what_the_work_needs(kernel):
    """chip_smoke.py's bounds for the two probes count what the work reads
    and writes once: the flags as bytes (B1), the parents that pass
    through, row_ptr entries of the rows that probe (at most all n + 1),
    an id per probe, the frontier words tested (at most all of them), and
    the outputs."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    n = 1000
    if kernel == "bottom_up_probe":
        unvisited, probes, hits, nw = 300, 1500, 200, 32
        nbytes = (n + 4 * (n - hits) + 8 * unvisited + 4 * probes + 4 * nw
                  + 8 * n)
        assert smoke.probe_cost(n, unvisited, probes, hits, nw) == (
            smoke.bound_ms(nbytes, 4 * n + 8 * probes))
        # few probing rows read their bounds; many read all of row_ptr
        assert smoke.probe_cost(n, 900, 10, 0, nw)[0] == smoke.bound_ms(
            n + 4 * n + 4 * (n + 1) + 40 + 40 + 8 * n, 0)[0]
    else:
        w, rows, probes, words = 2, 300, 900, 1500
        nbytes = 8 * n * w + 8 * rows + 4 * probes + 4 * words
        assert smoke.lane_probe_cost(n, w, rows, probes, words) == (
            smoke.bound_ms(nbytes, 4 * n * w + 3 * words))
        assert smoke.lane_probe_cost(n, w, n, 0, 10 * n * w)[0] == (
            smoke.bound_ms(8 * n * w + 4 * (n + 1) + 4 * n * w, 0)[0])


@pytest.mark.parametrize("lanes", [1, 32, 33])
@pytest.mark.parametrize("max_pos", [1, 8])
def test_relax_fallback_cuda_sparse_live_slots(cuda_device, lanes, max_pos):
    """relax_fallback as the engine's light relax meets it: about 3 % of
    the weights finite (most 32-slot chunks hold no live slot, or a few)
    and 90 % of the source rows +inf in every lane, rows of degree max_pos
    and max_pos + 1, a row over several segments and rows straddling
    32-slot chunks: bit-equal to the plain version."""
    rng = np.random.default_rng(lanes * max_pos)
    n = 4000
    deg = rng.integers(0, 70, n)
    deg[:4] = (max_pos, max_pos + 1, 3 * 512 + 40, 0)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    g = from_weighted_edges(src, dst, rng.uniform(0, 1, src.size), n,
                            symmetrize=False, drop_self_loops=False,
                            device=cuda_device)
    w = g.weights.clone()
    w[torch.from_numpy(rng.random(g.m) >= 0.03).to(cuda_device)] = float("inf")
    vals = relax_values(n + 5, lanes, lanes, cuda_device)
    vals[torch.from_numpy(rng.random(n + 5) < 0.9).to(cuda_device)] = float(
        "inf")
    base = semiring_relax_cuda(g.row_ptr, g.col_idx, w, vals, max_pos)
    args = (g.row_ptr, g.src_idx, g.col_idx, w, vals)
    want = relax_fallback_ref(*args, base.clone(), max_pos)
    got = relax_fallback_cuda(*args, base.clone(), max_pos)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not torch.equal(want, base)  # the residue lowered some lanes
    starts = g.row_ptr[:-1].long()
    assert bool(((starts % 32 > 24) & (g.deg > 16)).any())  # straddlers


@pytest.mark.parametrize("delta", [None, "tuple"])
def test_sssp_pipelined_on_gpu_matches_cpu(cuda_device, delta):
    """The weighted slice on the card, with lane refills: every SSSPResult
    field equals the CPU run's, and both relax kernels were launched."""
    g_cpu = rmat_weighted_graph(11, 16, seed=9, device="cpu")
    g_gpu = rmat_weighted_graph(11, 16, seed=9, device=cuda_device)
    roots = sample_roots(g_cpu, 40, seed=10)
    lanes = 16
    if delta == "tuple":
        delta = tuple(0.02 * (1 + i % 3) for i in range(lanes))
    common.reset_launches()
    want = sssp_pipelined(g_cpu, roots, delta=delta, lanes=lanes)
    got = sssp_pipelined(g_gpu, roots, delta=delta, lanes=lanes)
    for name, a, b in zip(want._fields, got, want):
        assert torch.equal(a.cpu(), b), name
    assert common.LAUNCHES["semiring_relax"] > 0
    assert common.LAUNCHES["relax_fallback"] > 0


def f32_bound(abs_sum64, deg):
    """Float32's summation bound for rows of ``deg`` terms against their
    float64 sum: 2 * deg * 2**-24 * sum |x_u| + 1e-7."""
    return 2.0 * deg.double()[:, None] * 2.0 ** -24 * abs_sum64 + 1e-7


@pytest.mark.parametrize("d", [1, 16, 47, 100, 130])
@pytest.mark.parametrize("k_max", [1, 4, 16])
def test_ell_kernels_cuda_match_plain(cuda_device, d, k_max):
    """ell_spmm and spmm_residue (in place) against their plain versions in
    float64, within float32's summation bound, on an R-MAT graph (rows of
    degree 0 and hubs deeper than k_max) with more feature rows than graph
    rows; two launches give the same bits."""
    g = rmat_graph(10, 16, seed=d + k_max, device=cuda_device)
    rng = np.random.default_rng(d * k_max)
    x = torch.from_numpy(rng.standard_normal((g.n + 37, d)).astype(
        np.float32)).to(cuda_device)
    neigh, valid = ell_pad(g, k_max)
    before = dict(common.LAUNCHES)
    y = ell_spmm_cuda(neigh, valid, x)
    assert torch.equal(ell_spmm_cuda(neigh, valid, x), y)
    x64 = x.double()
    slab = ell_spmm_ref(neigh, valid, x64)
    slab_abs = ell_spmm_ref(neigh, valid, x64.abs())
    assert bool(((y.double() - slab).abs()
                 <= f32_bound(slab_abs, g.deg.clamp(max=k_max))).all())
    y2 = y.clone()
    out = spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y, k_max)
    assert out is y
    spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y2, k_max)
    assert torch.equal(y, y2)
    full = spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx, x64,
                            slab.clone(), k_max)
    full_abs = spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx, x64.abs(),
                                slab_abs.clone(), k_max)
    assert bool(((y.double() - full).abs()
                 <= f32_bound(full_abs, g.deg)).all())
    assert bool((g.deg == 0).any()) and bool((g.deg > k_max).any())
    torch.cuda.synchronize()
    assert common.LAUNCHES["ell_spmm"] == before["ell_spmm"] + 2
    # the residue counts each kernel its C entry launched
    assert common.LAUNCHES["spmm_residue"] \
        == before["spmm_residue"] + 2 * residue_launches(d)


@pytest.mark.parametrize("d", [1, 4, 16, 47, 64, 65, 100, 130])
@pytest.mark.parametrize("k_max", [1, 4, 16, 33])
@pytest.mark.parametrize("aligned", [True, False])
def test_ell_spmm_cuda_bit_equal_plain(cuda_device, d, k_max, aligned):
    """ell_spmm against its plain version run in float32 on the card: the
    same bits (both sum each row in slot order), with more feature rows than
    graph rows; an x whose data does not start on 16 bytes takes the
    kernel's scalar loads. Two launches give the same bits."""
    g = rmat_graph(10, 16, seed=d + k_max, device=cuda_device)
    rng = np.random.default_rng(d * k_max + aligned)
    n_src = g.n + 37
    buf = torch.from_numpy(rng.standard_normal(n_src * d + 1).astype(
        np.float32)).to(cuda_device)
    x = buf[:-1].view(n_src, d) if aligned else buf[1:].view(n_src, d)
    assert (x.data_ptr() % 16 == 0) == aligned
    neigh, valid = ell_pad(g, k_max)
    y = ell_spmm_cuda(neigh, valid, x)
    want = ell_spmm_ref(neigh, valid, x)
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    assert torch.equal(ell_spmm_cuda(neigh, valid, x).view(torch.int32),
                       y.view(torch.int32))
    assert bool((g.deg == 0).any()) and bool((g.deg > k_max).any())


def segment_graph(k_max, device):
    """A CSR whose rows meet every case of spmm_residue's segments: a hub
    whose tail spans three segments, a tail ending exactly on a segment
    boundary, a tail of exactly one segment (starting and ending on
    boundaries), rows of degree 0, k_max and k_max + 1, a second hub
    whose tail starts mid-segment, then 3000 rows of 0-40 neighbours."""
    rng = np.random.default_rng(k_max)
    hub = k_max + 3 * SEG + 5
    deg = [hub, 4 * SEG - hub, SEG - k_max, k_max + SEG, 0, k_max,
           k_max + 1, 2 * SEG + 300]
    deg = np.array(deg + list(rng.integers(0, 41, 3000)))
    row_ptr = np.concatenate([[0], np.cumsum(deg)])
    assert row_ptr[2] == 4 * SEG and row_ptr[3] + k_max == 5 * SEG
    n = deg.size
    col = rng.integers(0, n + 37, row_ptr[-1])
    return from_numpy_graph(row_ptr, col, np.repeat(np.arange(n), deg),
                            device)


def test_residue_scratch_bound():
    """The fold's segments cover every slot, and its scratch is 2 *
    segments * d floats plus an int32 a segment."""
    assert residue_scratch(0, 16) == (0, 0)
    assert residue_scratch(SEG, 16) == (1, 4 * (2 * 16 + 1))
    assert residue_scratch(SEG + 1, 47) == (2, 4 * (2 * 2 * 47 + 2))
    for m in (1, SEG - 1, 5 * SEG, 61_859_140):
        segments, _ = residue_scratch(m, 1)
        assert (segments - 1) * SEG < m <= segments * SEG


@pytest.mark.parametrize("d", [16, 47])
@pytest.mark.parametrize("k_max", [4, 16])
def test_spmm_residue_cuda_segments(cuda_device, d, k_max):
    """spmm_residue on rows split across its fixed segments (hub tails,
    tails on segment boundaries): within float32's summation bound of the
    float64 plain version, and two launches give the same bits."""
    g = segment_graph(k_max, cuda_device)
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.standard_normal((g.n + 37, d)).astype(
        np.float32)).to(cuda_device)
    y0 = torch.from_numpy(rng.standard_normal((g.n, d)).astype(
        np.float32)).to(cuda_device)
    y, y2 = y0.clone(), y0.clone()
    spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y, k_max)
    spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y2, k_max)
    assert torch.equal(y, y2)
    x64 = x.double()
    want = spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx, x64,
                            y0.double(), k_max)
    want_abs = spmm_residue_ref(g.row_ptr, g.src_idx, g.col_idx, x64.abs(),
                                y0.double().abs(), k_max)
    assert bool(((y.double() - want).abs()
                 <= f32_bound(want_abs, g.deg + 1)).all())
    assert not torch.equal(y, y0)


def test_ell_kernels_cuda_empty_and_degree_zero(cuda_device):
    """An empty graph, and a graph whose rows all have degree 0."""
    g0 = from_numpy_graph(np.zeros(1), np.zeros(0), np.zeros(0), cuda_device)
    x = torch.ones((5, 3), device=cuda_device)
    neigh, valid = ell_pad(g0, 4)
    assert ell_spmm_cuda(neigh, valid, x).shape == (0, 3)
    g = from_numpy_graph(np.zeros(51), np.zeros(0), np.zeros(0), cuda_device)
    neigh, valid = ell_pad(g, 4)
    y = ell_spmm_cuda(neigh, valid, x)
    assert y.shape == (50, 3) and not bool(y.any())
    assert spmm_residue_cuda(g.row_ptr, g.src_idx, g.col_idx, x, y, 4) is y
    assert not bool(y.any())


def test_gcn_train_steps_on_gpu_match_cpu(cuda_device):
    """Three steps of the reduced gcn-cora at full_graph_sm on the card,
    from the same parameters and batches as on the CPU, within rtol 1e-4;
    each step calls each aggregation kernel 4 times (2 layers, forward
    and backward): ell_spmm launches once a call, spmm_residue the
    kernels of its column passes and merge at the layer's width."""
    arch = reduce_arch("gcn-cora")
    shape = arch.shape("full_graph_sm")
    init_fn, _ = param_builders(arch, shape)
    p_cpu = init_fn(torch.Generator().manual_seed(0))
    p_gpu = {k: v.to(cuda_device) for k, v in p_cpu.items()}
    s_cpu = init_opt_state(p_cpu, arch.opt)
    s_gpu = init_opt_state(p_gpu, arch.opt)
    step = make_step(arch, shape)
    d = shape.dims
    cfg = effective_cfg(arch, shape)
    for k in range(3):
        gb = synthetic_graph_batch(torch.Generator().manual_seed(k),
                                   d["n_nodes"], d["n_edges"], d["d_feat"],
                                   d["n_classes"])
        gb_gpu = gb._replace(**{f: getattr(gb, f).to(cuda_device) for f in (
            "senders", "receivers", "edge_mask", "feats", "pos", "labels",
            "node_mask", "graph_ids")})
        common.reset_launches()
        p_gpu, s_gpu, m_gpu = step(p_gpu, s_gpu, gb_gpu)
        torch.cuda.synchronize()
        assert common.LAUNCHES["ell_spmm"] == 4
        assert common.LAUNCHES["spmm_residue"] == 2 * sum(
            residue_launches(w) for w in (cfg.d_hidden, cfg.n_classes))
        p_cpu, s_cpu, m_cpu = step(p_cpu, s_cpu, gb)
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m_gpu[name]), float(m_cpu[name]),
                                       rtol=1e-4)
    for name in p_cpu:
        np.testing.assert_allclose(p_gpu[name].cpu().numpy(),
                                   p_cpu[name].numpy(), rtol=1e-4, atol=1e-6)
    assert build_adjacency(gb_gpu).fwd.device.type == "cuda"
