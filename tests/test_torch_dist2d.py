"""The port's 2-D grid MS-BFS engine against ``repro.core.dist2d``.

``dist2d_msbfs`` over ``partition_graph_2d(g, pr, pc)`` must give every
``MSBFSResult`` field (parent, depth, num_layers, edges_traversed and the
four traces), and the exchange meters ``exch_bytes`` and ``exch_log``, of
the reference's 2-D engine, bit for bit and as ints, and the fields of the
port's host engine ``msbfs_pipelined``: on the reference's property cases
(``tests/test_dist2d.py``, through ``build_case``) over the grids 1x1, 1x2,
2x1, 2x2, 4x1 and 1x4, dense and compressed, at 32- and 64-bit lane
words, one case with fewer lanes than roots. Also: a stream that enqueues
roots mid-sweep; the forced modes; the star and path graphs, where the
compressed bytes of a layer follow the frontier (``tests/test_dist2d.py``'s
byte test, here held to the reference's logs); ``LaneEngine(grid=,
compress=)`` with telemetry, whose recorded layers (every field but
``wall_ms``) equal the reference's; ``partition_graph_2d``'s arrays; the
validation errors.

The reference runs in ``run_in_subprocess(devices=4)`` children, one per
word width and case, with ``LANE_WORD_BITS`` and ``JAX_ENABLE_X64`` pinned
as ``tests/test_dist2d.py`` pins them; they write their results to files.
The port runs once per width on four gloo ranks
(``distributed.ranks.run_ranks``, the width set in each rank before the
port is imported), each grid of fewer than four ranks as a sub-mesh.
Every child and launch starts together on first use. The case graphs are
built here, by the reference's ``build_case``, and go to both sides as
arrays.
"""
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.distributed.ranks import run_ranks

U64_ENV = {"LANE_WORD_BITS": "64", "JAX_ENABLE_X64": "1"}
U32_ENV = {"LANE_WORD_BITS": "32", "JAX_ENABLE_X64": "0"}
BITS = (32, 64)
FIELDS = ("parent", "depth", "num_layers", "edges_traversed", "trace_dir",
          "trace_vf", "trace_ef", "trace_eu")
GRIDS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (1, 4))
GRID_IDS = [f"{pr}x{pc}" for pr, pc in GRIDS]
ROOTS = (0, 5, 17, 33, 59)
# the reference's matrix cases (tests/test_dist2d.py), the first with
# fewer lanes than roots so the queue refills: shape, seed, lanes
CASES = (("random", 3, 2), ("two_components", 11, 32))
STREAM_ROOTS = (2, 9, 21, 40, 57)
ENGINE_ROOTS = (1, 2, 3)


def graph_arrays():
    """The graphs of every case, built by the reference's ``build_case``
    (and, for the engine case, ``repro.core.csr.from_edges``), as host
    arrays: {name: (row_ptr, col_idx, src_idx)}."""
    from test_msbfs_properties import build_case

    from repro.core.csr import from_edges

    def arrays(g):
        return tuple(np.asarray(a) for a in (g.row_ptr, g.col_idx,
                                             g.src_idx))
    out = {}
    for shape, seed, _ in CASES:
        out[f"{shape}{seed}"] = arrays(build_case(60, 150, seed, shape,
                                                  False, False)[0])
    for name, args in (("stream", (60, 150, 5, "random")),
                       ("modes", (60, 150, 7, "random")),
                       ("star", (256, 0, 0, "star")),
                       ("path", (64, 0, 0, "path"))):
        out[name] = arrays(build_case(*args, False, False)[0])
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 50, 140), rng.integers(0, 50, 140)
    out["engine"] = arrays(from_edges(src, dst, 50, symmetrize=True,
                                      drop_self_loops=True, dedup=False))
    return out


REF_CODE = """
import numpy as np, jax.numpy as jnp
from repro.analytics.engine import LaneEngine
from repro.core.csr import CSRGraph
from repro.core.dist2d import (
    dist2d_msbfs_engine_drain, dist2d_msbfs_engine_enqueue,
    dist2d_msbfs_engine_init, dist2d_msbfs_engine_result,
    dist2d_msbfs_engine_step, mesh2d, partition_graph_2d)
from repro.core.packed import LANE_WORD_BITS
from repro.obs import Telemetry

assert LANE_WORD_BITS == {bits}
FIELDS = {fields!r}
graphs = dict(np.load({graphs!r}))
out = {{}}


def graph(name):
    return CSRGraph(*(jnp.asarray(graphs[f"{{name}}/{{f}}"])
                      for f in ("row_ptr", "col_idx", "src_idx")))


def put(prefix, res, s):
    for f in FIELDS:
        out[f"{{prefix}}/{{f}}"] = np.asarray(getattr(res, f))
    out[f"{{prefix}}/exch_bytes"] = np.asarray(s.exch_bytes)
    out[f"{{prefix}}/exch_log"] = np.asarray(s.exch_log)


def sweep(g, roots, pr, pc, lanes, compress, mode="hybrid"):
    dg = partition_graph_2d(g, pr, pc)
    mesh = mesh2d(pr, pc)
    s = dist2d_msbfs_engine_init(dg, mesh, capacity=len(roots), lanes=lanes)
    s = dist2d_msbfs_engine_enqueue(s, jnp.asarray(roots, jnp.int32))
    s = dist2d_msbfs_engine_drain(dg, s, mesh, mode, compress=compress)
    return dist2d_msbfs_engine_result(dg, s, mesh), s


for name, lanes in {matrix!r}:
    g = graph(name)
    for pr, pc in {grids!r}:
        for compress in (False, True):
            put(f"{{name}}/{{pr}}x{{pc}}/{{int(compress)}}",
                *sweep(g, {roots!r}, pr, pc, lanes, compress))

if {extras!r}:
    g = graph("stream")
    dg = partition_graph_2d(g, 2, 2)
    mesh = mesh2d(2, 2)
    roots = jnp.asarray({stream!r}, jnp.int32)
    s = dist2d_msbfs_engine_init(dg, mesh, capacity=5, lanes=32)
    s = dist2d_msbfs_engine_enqueue(s, roots[:2])
    s = dist2d_msbfs_engine_step(dg, s, mesh, compress=True)
    s = dist2d_msbfs_engine_enqueue(s, roots[2:])
    s = dist2d_msbfs_engine_drain(dg, s, mesh, compress=True)
    put("stream", dist2d_msbfs_engine_result(dg, s, mesh), s)
    g = graph("modes")
    for mode in ("topdown", "bottomup"):
        put(f"mode/{{mode}}", *sweep(g, {roots!r}, 2, 2, 32, True, mode))
    for name in ("star", "path"):
        for compress in (False, True):
            _, s = sweep(graph(name), [0], 2, 2, 32, compress)
            out[f"bytes/{{name}}/{{int(compress)}}"] = np.asarray(s.exch_log)
    tel = Telemetry()
    eng = LaneEngine(graph("engine"), grid=(2, 2), compress=True,
                     telemetry=tel)
    res = eng.sweep(np.asarray({engine_roots!r}, np.int32))
    out["engine/depth"] = np.asarray(res.depth)
    rec = tel.sweeps[0]
    out["engine/records"] = np.asarray(repr([
        {{k: v for k, v in r.as_dict().items() if k != "wall_ms"}}
        for r in rec.records]))
    out["engine/meta"] = np.asarray(repr((rec.engine, rec.meta)))
np.savez({out!r}, **out)
print("REF_DIST2D_OK")
"""


def grid_mesh(pr, pc):
    """A ("row", "col") mesh of ``pr x pc`` of the four ranks: ``mesh2d``
    for four, else a slice of a ("rest", "row", "col") mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.dist2d import mesh2d
    if pr * pc == 4:
        return mesh2d(pr, pc, "cpu")
    return init_device_mesh("cpu", (4 // (pr * pc), pr, pc),
                            mesh_dim_names=("rest", "row", "col"))[
        "row", "col"]


def dist2d_rank(bits, graphs):
    """Every rank, at ``bits``-bit lane words (set before the port is
    imported): the matrix, the stream, the forced modes, the byte logs and
    the telemetry engine. Rank 0 also runs the host engine. Returns rank
    0's results."""
    import os
    os.environ["LANE_WORD_BITS"] = str(bits)
    import torch.distributed as dist

    from repro_torch.analytics import LaneEngine
    from repro_torch.core import dist2d as d2
    from repro_torch.core.csr import from_numpy_graph
    from repro_torch.core.msbfs import msbfs_pipelined
    from repro_torch.core.packed import LANE_WORD_BITS
    from repro_torch.obs import Telemetry
    host = dist.get_rank() == 0
    meshes = {grid: grid_mesh(*grid) for grid in GRIDS}
    out = {"word_bits": LANE_WORD_BITS}

    def graph(name):
        return from_numpy_graph(*graphs[name], "cpu")

    def put(prefix, res, s):
        out[prefix] = {f: getattr(res, f).numpy() for f in FIELDS}
        out[prefix].update(exch_bytes=s.exch_bytes, exch_log=s.exch_log)

    def sweep(g, roots, grid, lanes, compress, mode="hybrid"):
        dg = d2.partition_graph_2d(g, *grid)
        mesh = meshes[grid]
        s = d2.dist2d_msbfs_engine_init(dg, mesh, len(roots), lanes)
        s = d2.dist2d_msbfs_engine_enqueue(s, roots)
        s = d2.dist2d_msbfs_engine_drain(dg, s, mesh, mode,
                                         compress=compress)
        return d2.dist2d_msbfs_engine_result(dg, s, mesh), s

    for shape, seed, lanes in CASES:
        name = f"{shape}{seed}"
        g = graph(name)
        for grid in GRIDS:
            for compress in (False, True):
                put(f"{name}/{grid[0]}x{grid[1]}/{int(compress)}",
                    *sweep(g, ROOTS, grid, lanes, compress))
        if host:
            res = msbfs_pipelined(g, ROOTS, lanes=lanes)
            out[f"{name}/host"] = {f: getattr(res, f).numpy()
                                   for f in FIELDS}

    g = graph("stream")
    dg = d2.partition_graph_2d(g, 2, 2)
    mesh = meshes[2, 2]
    s = d2.dist2d_msbfs_engine_init(dg, mesh, 5, 32)
    s = d2.dist2d_msbfs_engine_enqueue(s, STREAM_ROOTS[:2])
    s = d2.dist2d_msbfs_engine_step(dg, s, mesh, compress=True)
    out["stream/idle_after_one"] = d2.dist2d_msbfs_engine_idle(s)
    s = d2.dist2d_msbfs_engine_enqueue(s, STREAM_ROOTS[2:])
    s = d2.dist2d_msbfs_engine_drain(dg, s, mesh, compress=True)
    out["stream/idle"] = d2.dist2d_msbfs_engine_idle(s)
    put("stream", d2.dist2d_msbfs_engine_result(dg, s, mesh), s)
    g = graph("modes")
    for mode in ("topdown", "bottomup"):
        put(f"mode/{mode}", *sweep(g, ROOTS, (2, 2), 32, True, mode))
        if host:
            res = msbfs_pipelined(g, ROOTS, mode)
            out[f"mode/{mode}/host"] = {f: getattr(res, f).numpy()
                                        for f in FIELDS}
    for name in ("star", "path"):
        for compress in (False, True):
            _, s = sweep(graph(name), [0], (2, 2), 32, compress)
            out[f"bytes/{name}/{int(compress)}"] = s.exch_log

    tel = Telemetry()
    g = graph("engine")
    eng = LaneEngine(g, grid=(2, 2), compress=True, telemetry=tel)
    res = eng.sweep(ENGINE_ROOTS)
    out["engine/depth"] = res.depth.numpy()
    out["engine/plain_depth"] = LaneEngine(g, grid=(2, 2)).sweep(
        ENGINE_ROOTS).depth.numpy()
    rec = tel.sweeps[0]
    out["engine/records"] = repr([
        {k: v for k, v in r.as_dict().items() if k != "wall_ms"}
        for r in rec.records])
    out["engine/meta"] = repr((rec.engine, rec.meta))
    out["engine/shape"] = (eng.ndev, eng.grid, eng.compress)
    return out


@pytest.fixture(scope="module")
def graphs():
    return graph_arrays()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, graphs):
    """Every child and launch of the module, started together on first
    use: {("ref", bits, i): (future, npz path), ("port", bits): future}."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("dist2d")
    gpath = tmp / "graphs.npz"
    np.savez(gpath, **{f"{name}/{f}": a for name, arrs in graphs.items()
                       for f, a in zip(("row_ptr", "col_idx", "src_idx"),
                                       arrs)})
    pool = ThreadPoolExecutor(6)
    jobs = {}
    for bits in BITS:
        jobs["port", bits] = pool.submit(run_ranks, dist2d_rank, 4, bits,
                                         graphs, device="cpu")
        for i, (shape, seed, lanes) in enumerate(CASES):
            path = tmp / f"ref{bits}_{i}.npz"
            code = REF_CODE.format(
                bits=bits, fields=FIELDS, graphs=str(gpath),
                matrix=[(f"{shape}{seed}", lanes)], grids=GRIDS, roots=ROOTS,
                extras=i == 1, stream=STREAM_ROOTS,
                engine_roots=ENGINE_ROOTS, out=str(path))
            jobs["ref", bits, i] = (pool.submit(
                run_in_subprocess, code, devices=4, timeout=900,
                env_extra=U64_ENV if bits == 64 else U32_ENV), path)
    assert os.path.exists(gpath)
    yield jobs
    pool.shutdown()


@pytest.fixture(scope="module", params=BITS)
def bits(request):
    return request.param


@pytest.fixture(scope="module")
def ref(bits, jobs):
    out = {}
    for i in range(len(CASES)):
        future, path = jobs["ref", bits, i]
        assert "REF_DIST2D_OK" in future.result()
        out.update(np.load(path))
    return out


@pytest.fixture(scope="module")
def port(bits, jobs):
    out = jobs["port", bits].result()
    assert out["word_bits"] == bits
    return out


def assert_run(got: dict, ref: dict, prefix: str, host: dict | None = None):
    """Every field equal to the reference's (and the host engine's), the
    byte meter and the per-step log equal as ints."""
    for f in FIELDS:
        assert got[f].dtype == np.int32, (prefix, f)
        np.testing.assert_array_equal(got[f], ref[f"{prefix}/{f}"],
                                      err_msg=f"{prefix} {f}")
        if host is not None:
            np.testing.assert_array_equal(got[f], host[f],
                                          err_msg=f"{prefix} host {f}")
    assert type(got["exch_bytes"]) is int
    assert got["exch_bytes"] == int(ref[f"{prefix}/exch_bytes"]), prefix
    np.testing.assert_array_equal(got["exch_log"],
                                  ref[f"{prefix}/exch_log"].astype(np.int64),
                                  err_msg=f"{prefix} exch_log")
    assert got["exch_bytes"] == int(got["exch_log"].sum()) > 0, prefix


@pytest.mark.parametrize("compress", [False, True], ids=["dense",
                                                         "compressed"])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_parity_matrix(port, ref, case, grid, compress):
    shape, seed, _ = CASES[case]
    name = f"{shape}{seed}"
    prefix = f"{name}/{grid[0]}x{grid[1]}/{int(compress)}"
    assert_run(port[prefix], ref, prefix, port[f"{name}/host"])


def test_streaming_enqueue_mid_sweep(port, ref):
    assert port["stream/idle_after_one"] is False
    assert port["stream/idle"] is True
    assert_run(port["stream"], ref, "stream")


@pytest.mark.parametrize("mode", ["topdown", "bottomup"])
def test_forced_modes(port, ref, mode):
    assert_run(port[f"mode/{mode}"], ref, f"mode/{mode}",
               port[f"mode/{mode}/host"])


@pytest.mark.parametrize("name", ["star", "path"])
def test_compressed_bytes_track_the_frontier(port, ref, name):
    """The byte logs equal the reference's, and show what its byte test
    asserts: dense layers ship the same bytes whatever the frontier,
    compressed ones fewer (on the path, a quarter of dense at most)."""
    dense, comp = (port[f"bytes/{name}/{c}"] for c in (0, 1))
    for c, log in enumerate((dense, comp)):
        np.testing.assert_array_equal(
            log, ref[f"bytes/{name}/{c}"].astype(np.int64), err_msg=name)
    live = dense > 0
    assert (dense[live] == dense[live][0]).all()
    assert (comp[live] < dense[live]).all() and comp.sum() < dense.sum()
    if name == "star":
        assert live.sum() == 2 and comp[1] < comp[0]
    else:
        assert (comp[live] < dense[0] // 4).all()


def test_lane_engine_grid_with_telemetry(port, ref, graphs):
    """``LaneEngine(grid=(2, 2), compress=True, telemetry=)``: the depths
    of the host engine and of the reference's engine, the recorded layers
    (exchange bytes and wire format among their fields) equal to the
    reference's, and the same depths unrecorded and dense."""
    from repro_torch.core.csr import from_numpy_graph
    from repro_torch.core.msbfs import msbfs_pipelined
    np.testing.assert_array_equal(port["engine/depth"], ref["engine/depth"])
    np.testing.assert_array_equal(port["engine/plain_depth"],
                                  port["engine/depth"])
    want = msbfs_pipelined(from_numpy_graph(*graphs["engine"], "cpu"),
                           ENGINE_ROOTS).depth.numpy()
    np.testing.assert_array_equal(port["engine/depth"], want)
    assert port["engine/records"] == str(ref["engine/records"])
    assert "'exch_format': 'compressed'" in port["engine/records"]
    assert port["engine/meta"] == str(ref["engine/meta"])
    assert port["engine/shape"] == (4, (2, 2), True)


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (2, 3), (3, 2), (1, 4),
                                  (4, 1)])
def test_partition_graph_2d_matches_reference(graphs, grid):
    from repro.core.csr import CSRGraph as JCSRGraph
    from repro.core.dist2d import partition_graph_2d as ref_partition

    from repro_torch.core.csr import from_numpy_graph
    from repro_torch.core.dist2d import partition_graph_2d
    for name in ("random3", "star", "engine"):
        arrs = graphs[name]
        got = partition_graph_2d(from_numpy_graph(*arrs, "cpu"), *grid)
        want = ref_partition(JCSRGraph(*arrs), *grid)
        for f in ("row_ptr", "col_loc", "col_gid", "src_loc", "deg"):
            a = getattr(got, f)
            assert a.dtype == np.int32, (name, f)
            np.testing.assert_array_equal(a, np.asarray(getattr(want, f)),
                                          err_msg=f"{name} {grid} {f}")
        for f in ("n", "n_orig", "pr", "pc", "chunk", "m_loc", "n_loc_r",
                  "n_x"):
            assert getattr(got, f) == getattr(want, f), (name, grid, f)
        np.testing.assert_array_equal(
            got.global_deg()[:got.n_orig], np.diff(arrs[0]))


def test_validation_errors(graphs):
    """Without a process group: the partition's and the mesh's checks,
    and the engine facade's knob rules, as the reference raises them."""
    from repro_torch.analytics import LaneEngine
    from repro_torch.core.csr import from_numpy_graph
    from repro_torch.core.dist2d import (_check_partition_2d, mesh2d,
                                         partition_graph_2d)
    g = from_numpy_graph(*graphs["engine"], "cpu")
    with pytest.raises(ValueError, match="grid dims"):
        partition_graph_2d(g, 0, 2)
    with pytest.raises(ValueError, match="grid dims"):
        mesh2d(2, 0, "cpu")
    with pytest.raises(RuntimeError, match="run_ranks"):
        mesh2d(2, 2, "cpu")

    class FakeMesh:
        def __init__(self, names, shape):
            self.mesh_dim_names = names
            self.mesh = torch.zeros(shape)
    dg = partition_graph_2d(g, 2, 1)
    _check_partition_2d(dg, FakeMesh(("row", "col"), (2, 1)))
    with pytest.raises(ValueError, match="repartition"):
        _check_partition_2d(dg, FakeMesh(("row", "col"), (1, 2)))
    with pytest.raises(ValueError, match="mesh2d"):
        _check_partition_2d(dg, FakeMesh(("data",), (2,)))
    with pytest.raises(ValueError, match="not both"):
        LaneEngine(g, grid=(2, 2), mesh=object())
    with pytest.raises(ValueError, match="needs grid"):
        LaneEngine(g, compress=True)


# ---------------------------------------------------------------------------
# On the card: the lane kernels on the blocks of non-square grids
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("grid", [(1, 4), (4, 1), (2, 2)])
def test_lane_kernels_cuda_on_grid_blocks(cuda_device, grid):
    """msbfs_probe and both forms of segment_or on every block of a 1x4,
    4x1 and 2x2 partition against the column block's frontier slice
    (n_x rows, fewer than the block's rows on 1x4): each equal to its
    plain version."""
    from repro_torch.core.dist2d import partition_graph_2d
    from repro_torch.graph.generator import rmat_graph
    from repro_torch.kernels.msbfs_probe.kernel import msbfs_probe_cuda
    from repro_torch.kernels.msbfs_probe.ref import msbfs_probe_ref
    from repro_torch.kernels.segment_or.kernel import segment_or_rows_cuda
    from repro_torch.kernels.segment_or.ref import segment_or_rows_ref
    pr, pc = grid
    g = rmat_graph(12, 16, seed=pr, device=cuda_device)
    dg = partition_graph_2d(g, pr, pc)
    rng = np.random.default_rng(pc)

    def words(rows):
        return torch.from_numpy(rng.integers(
            0, 2 ** 32, (rows, 2), dtype=np.uint32).view(np.int32)).to(
                cuda_device)
    sel = torch.full((2,), -1, dtype=torch.int32, device=cuda_device)
    for d in range(pr * pc):
        bg = dg.local(d, cuda_device).g
        x = words(dg.n_x) & words(dg.n_x)
        need = ~(words(dg.n_loc_r) & words(dg.n_loc_r))
        acc = msbfs_probe_cuda(bg.row_ptr, need, bg.col_idx, x, 8)
        assert torch.equal(acc, msbfs_probe_ref(bg.row_ptr[:-1],
                                                bg.row_ptr.diff(), need,
                                                bg.col_idx, x, 8))
        found = acc & need
        residue = (((need & ~found) != 0).any(dim=-1)
                   & (bg.deg > 8)).to(torch.int32)
        for args in ((bg.row_ptr, bg.col_idx, x, need, None, found, residue,
                      8),
                     (bg.row_ptr, bg.col_idx, x, need, sel, None, None, 0)):
            assert torch.equal(segment_or_rows_cuda(*args),
                               segment_or_rows_ref(*args)), (grid, d)
