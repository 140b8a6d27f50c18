"""The port's distributed delta-stepping SSSP against
``repro.core.dist_sssp``.

``dist_sssp`` over ``partition_weighted_graph(wg, ndev)`` at 1, 2 and 4
ranks and ``dist2d_sssp`` over ``partition_weighted_graph_2d(wg, pr, pc)``
on the grids 1x1, 1x2, 2x1, 2x2, 4x1 and 1x4, dense and compressed, must
give every ``SSSPResult`` field (sources, the float32 distances, steps,
truncation flags, bucket and phase traces) of the reference's engines bit
for bit, the byte meters ``exch_bytes`` and ``exch_log`` as ints, and the
fields of the port's host engine ``sssp_pipelined``: on two of the
reference's property cases (``tests/test_dist_sssp.py``, through
``test_sssp_properties.build_case``) with fewer lanes than sources, one at
the default delta (``default_delta_dist``, a width whose reciprocal is
inexact in float32) and one with a per-lane tuple of widths. Also: the
unit-weight anchor (distances as depths equal ``dist_msbfs``'s); a 2-D
stream that enqueues sources mid-sweep; the path graph, where compressed
bytes follow the active frontier; ``LaneEngine.sssp_sweep`` on a 2-rank
mesh and a 2x2 grid with telemetry, whose recorded steps (every field but
``wall_ms``) equal the reference's; ``default_delta_dist``; the weighted
partitions' arrays.

The reference runs in three ``run_in_subprocess(devices=4)`` children
(the two matrix cases and the rest), which write their results to files;
the port on four gloo ranks (``distributed.ranks.run_ranks``), each mesh
or grid of fewer than four ranks as a sub-mesh. All start together on
first use. Lane words play no part in these engines, so they run at the
default width. The graphs are built here, by the reference's
``build_case``, and go to both sides as arrays.
"""
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.distributed.ranks import run_ranks

U32_ENV = {"LANE_WORD_BITS": "32", "JAX_ENABLE_X64": "0"}
FIELDS = ("sources", "dist", "steps", "truncated", "trace_bucket",
          "trace_phase")
NDEVS = (1, 2, 4)
GRIDS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (1, 4))
GRID_IDS = [f"{pr}x{pc}" for pr, pc in GRIDS]
SHAPES = [("1d", n) for n in NDEVS] + [("2d", g) for g in GRIDS]
SHAPE_IDS = [f"1d-{n}" for n in NDEVS] + [f"2d-{i}" for i in GRID_IDS]
# (name, build_case args, delta): the default width, and a per-lane tuple
# of widths with inexact float32 reciprocals; lanes are half the sources
CASES = (("random3", (48, 140, 3, "random", "uniform"), None),
         ("two11", (48, 140, 11, "two_components", "with_zeros"),
          "tuple"))
TUPLE_WIDTHS = (0.3, 0.7, 3.0)
GRAPH_FIELDS = ("row_ptr", "col_idx", "src_idx", "weights")


def graph_arrays():
    """{name: (row_ptr, col_idx, src_idx, weights, sources)} of every case,
    built by the reference's ``build_case`` (and its weighted path)."""
    from test_sssp_properties import build_case

    from repro.core.csr import from_weighted_edges

    def arrays(wg, sources):
        return tuple(np.asarray(a) for a in wg) + (
            np.asarray(sources, np.int32),)
    out = {}
    for name, args, _ in CASES:
        wg, sources, _ = build_case(*args, dup_edges=False)
        out[name] = arrays(wg, sources)
    for name, seed, model in (("anchor", 5, "unit"),
                              ("stream", 9, "uniform"),
                              ("engine", 13, "uniform")):
        wg, sources, delta = build_case(48, 140, seed, "random", model,
                                        dup_edges=False)
        out[name] = arrays(wg, sources)
        out[f"{name}/delta"] = delta
    src = np.arange(31)
    out["path"] = arrays(from_weighted_edges(src, src + 1, np.ones(31), 32),
                         [0])
    return out


def case_delta(name, kind, lanes):
    if kind == "tuple":
        return tuple(TUPLE_WIDTHS[i % 3] for i in range(lanes))
    return None


REF_CODE = """
import numpy as np, jax.numpy as jnp
from repro.analytics.engine import LaneEngine
from repro.core.csr import WeightedCSRGraph
from repro.core.dist_msbfs import dist_msbfs, partition_graph
from repro.core.dist_sssp import (
    default_delta_dist, dist2d_sssp_engine_drain, dist2d_sssp_engine_enqueue,
    dist2d_sssp_engine_idle, dist2d_sssp_engine_init,
    dist2d_sssp_engine_result, dist2d_sssp_engine_step,
    dist_sssp, dist_sssp_engine_drain, dist_sssp_engine_enqueue,
    dist_sssp_engine_init, dist_sssp_engine_result, host_mesh, mesh2d,
    partition_weighted_graph, partition_weighted_graph_2d, dist2d_sssp)
from repro.obs import Telemetry

FIELDS = {fields!r}
graphs = dict(np.load({graphs!r}))
out = {{}}


def graph(name):
    return WeightedCSRGraph(*(jnp.asarray(graphs[f"{{name}}/{{f}}"])
                              for f in {graph_fields!r}))


def sources(name):
    return jnp.asarray(graphs[f"{{name}}/sources"])


def put(prefix, res, s=None):
    for f in FIELDS:
        out[f"{{prefix}}/{{f}}"] = np.asarray(getattr(res, f))
    if s is not None:
        out[f"{{prefix}}/exch_bytes"] = np.asarray(s.exch_bytes)
        out[f"{{prefix}}/exch_log"] = np.asarray(s.exch_log)


def run(kind, shape, wg, src, delta, lanes, compress):
    if kind == "1d":
        dwg = partition_weighted_graph(wg, shape)
        mesh = host_mesh(shape)
        init, enq, drain, result = (dist_sssp_engine_init,
                                    dist_sssp_engine_enqueue,
                                    dist_sssp_engine_drain,
                                    dist_sssp_engine_result)
    else:
        dwg = partition_weighted_graph_2d(wg, *shape)
        mesh = mesh2d(*shape)
        init, enq, drain, result = (dist2d_sssp_engine_init,
                                    dist2d_sssp_engine_enqueue,
                                    dist2d_sssp_engine_drain,
                                    dist2d_sssp_engine_result)
    if delta is None:
        delta = default_delta_dist(dwg)
        out[f"default_delta/{{kind}}/{{shape}}"] = np.asarray(delta)
    s = enq(init(dwg, mesh, capacity=src.shape[0], lanes=lanes), src)
    s = drain(dwg, s, mesh, delta, compress=compress)
    return result(dwg, s), s


for name, delta, lanes, shapes in {matrix!r}:
    wg = graph(name)
    for kind, shape in shapes:
        for compress in (False, True):
            put(f"{{name}}/{{kind}}/{{shape}}/{{int(compress)}}",
                *run(kind, shape, wg, sources(name), delta, lanes, compress))

if {extras!r}:
    wg = graph("anchor")
    src = sources("anchor")
    lanes = max(1, src.shape[0] // 2)
    out["anchor/msbfs"] = np.asarray(dist_msbfs(
        partition_graph(wg.csr, 2), src, host_mesh(2)).depth)
    out["anchor/1d"] = np.asarray(dist_sssp(
        partition_weighted_graph(wg, 2), src, host_mesh(2), delta=1.0,
        lanes=lanes).as_depth())
    out["anchor/2d"] = np.asarray(dist2d_sssp(
        partition_weighted_graph_2d(wg, 2, 2), src, mesh2d(2, 2),
        delta=1.0, lanes=lanes, compress=True).as_depth())

    wg = graph("stream")
    src = sources("stream")
    delta = float(graphs["stream/delta"])
    dwg2 = partition_weighted_graph_2d(wg, 2, 2)
    mesh = mesh2d(2, 2)
    s = dist2d_sssp_engine_init(dwg2, mesh, capacity=src.shape[0], lanes=2)
    s = dist2d_sssp_engine_enqueue(s, src[:2])
    s = dist2d_sssp_engine_step(dwg2, s, mesh, delta, compress=True)
    s = dist2d_sssp_engine_enqueue(s, src[2:])
    while not dist2d_sssp_engine_idle(s):
        s = dist2d_sssp_engine_step(dwg2, s, mesh, delta, compress=True)
    put("stream", dist2d_sssp_engine_result(dwg2, s), s)

    wg = graph("path")
    dwg2 = partition_weighted_graph_2d(wg, 2, 2)
    for compress in (False, True):
        s = dist2d_sssp_engine_init(dwg2, mesh, capacity=1, lanes=1)
        s = dist2d_sssp_engine_enqueue(s, sources("path"))
        s = dist2d_sssp_engine_drain(dwg2, s, mesh, 1.0, compress=compress)
        put(f"path/{{int(compress)}}", dist2d_sssp_engine_result(dwg2, s), s)

    wg = graph("engine")
    src = np.asarray(graphs["engine/sources"])
    delta = float(graphs["engine/delta"])
    for name, kwargs in (("mesh", dict(ndev=2)),
                         ("grid", dict(grid=(2, 2), compress=True))):
        tel = Telemetry()
        eng = LaneEngine(wg, telemetry=tel, **kwargs)
        put(f"engine/{{name}}", eng.sssp_sweep(src, delta=delta))
        rec = tel.sweeps[0]
        out[f"engine/{{name}}/records"] = np.asarray(repr([
            {{k: v for k, v in r.as_dict().items() if k != "wall_ms"}}
            for r in rec.records]))
        out[f"engine/{{name}}/meta"] = np.asarray(repr((rec.engine,
                                                       rec.meta)))
np.savez({out!r}, **out)
print("REF_DIST_SSSP_OK")
"""


def sub_mesh(kind, shape):
    """The 1-D mesh of ``shape`` ranks or the ``shape`` grid, of the four
    ranks: the whole group's mesh for four, else a slice."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.dist_sssp import host_mesh, mesh2d
    if kind == "1d":
        if shape == 4:
            return host_mesh(4, "cpu")
        return init_device_mesh("cpu", (4 // shape, shape),
                                mesh_dim_names=("rest", "data"))["data"]
    pr, pc = shape
    if pr * pc == 4:
        return mesh2d(pr, pc, "cpu")
    return init_device_mesh("cpu", (4 // (pr * pc), pr, pc),
                            mesh_dim_names=("rest", "row", "col"))[
        "row", "col"]


def fields(res, s=None) -> dict:
    out = {f: getattr(res, f).numpy() for f in FIELDS}
    if s is not None:
        out.update(exch_bytes=s.exch_bytes, exch_log=s.exch_log)
    return out


def dist_sssp_rank(graphs):
    """Every rank: the matrix, the anchor, the stream, the path bytes and
    the two engines with telemetry; rank 0 also runs the host engine.
    Returns rank 0's results."""
    import torch.distributed as dist

    from repro_torch.analytics import LaneEngine
    from repro_torch.core import dist_sssp as ds
    from repro_torch.core.csr import from_numpy_weighted_graph
    from repro_torch.core.dist_msbfs import dist_msbfs, partition_graph
    from repro_torch.obs import Telemetry
    from repro_torch.traversal.sssp import default_delta, sssp_pipelined
    host = dist.get_rank() == 0
    meshes = {shape: sub_mesh(*shape) for shape in SHAPES}
    out = {}

    def graph(name):
        return from_numpy_weighted_graph(*graphs[name][:4], "cpu")

    def run(kind, shape, wg, src, delta, lanes, compress):
        if kind == "1d":
            dwg = ds.partition_weighted_graph(wg, shape)
            init, drain, result = (ds.dist_sssp_engine_init,
                                   ds.dist_sssp_engine_drain,
                                   ds.dist_sssp_engine_result)
        else:
            dwg = ds.partition_weighted_graph_2d(wg, *shape)
            init, drain, result = (ds.dist2d_sssp_engine_init,
                                   ds.dist2d_sssp_engine_drain,
                                   lambda d, s: ds.dist2d_sssp_engine_result(
                                       d, s))
        mesh = meshes[kind, shape]
        if delta is None:
            delta = ds.default_delta_dist(dwg)
            out[f"default_delta/{kind}/{shape}"] = delta
        s = ds.dist_sssp_engine_enqueue(init(dwg, mesh, len(src), lanes),
                                        src)
        s = drain(dwg, s, mesh, delta, compress=compress)
        return fields(result(dwg, s), s)

    for name, _, kind_delta in CASES:
        wg = graph(name)
        src = graphs[name][4]
        lanes = max(1, len(src) // 2)
        delta = case_delta(name, kind_delta, lanes)
        for kind, shape in SHAPES:
            for compress in (False, True):
                out[f"{name}/{kind}/{shape}/{int(compress)}"] = run(
                    kind, shape, wg, src, delta, lanes, compress)
        if host:
            out[f"{name}/host"] = fields(sssp_pipelined(
                wg, src, delta=delta, lanes=lanes))
            out[f"{name}/host_delta"] = default_delta(wg)

    wg = graph("anchor")
    src = graphs["anchor"][4]
    lanes = max(1, len(src) // 2)
    mesh2 = meshes["1d", 2]
    out["anchor/msbfs"] = dist_msbfs(partition_graph(wg.csr, 2), src,
                                     mesh2).depth.numpy()
    out["anchor/1d"] = ds.dist_sssp(
        ds.partition_weighted_graph(wg, 2), src, mesh2, delta=1.0,
        lanes=lanes).as_depth().numpy()
    out["anchor/2d"] = ds.dist2d_sssp(
        ds.partition_weighted_graph_2d(wg, 2, 2), src, meshes["2d", (2, 2)],
        delta=1.0, lanes=lanes, compress=True).as_depth().numpy()

    wg = graph("stream")
    src = graphs["stream"][4]
    delta = float(graphs["stream/delta"])
    dwg2 = ds.partition_weighted_graph_2d(wg, 2, 2)
    mesh = meshes["2d", (2, 2)]
    s = ds.dist2d_sssp_engine_init(dwg2, mesh, len(src), 2)
    s = ds.dist2d_sssp_engine_enqueue(s, src[:2])
    s = ds.dist2d_sssp_engine_step(dwg2, s, mesh, delta, compress=True)
    s = ds.dist2d_sssp_engine_enqueue(s, src[2:])
    while not ds.dist2d_sssp_engine_idle(s):
        s = ds.dist2d_sssp_engine_step(dwg2, s, mesh, delta, compress=True)
    out["stream"] = fields(ds.dist2d_sssp_engine_result(dwg2, s), s)
    if host:
        out["stream/host"] = fields(sssp_pipelined(wg, src, delta=delta,
                                                   lanes=2))

    wg = graph("path")
    dwg2 = ds.partition_weighted_graph_2d(wg, 2, 2)
    for compress in (False, True):
        s = ds.dist2d_sssp_engine_init(dwg2, mesh, 1, 1)
        s = ds.dist2d_sssp_engine_enqueue(s, graphs["path"][4])
        s = ds.dist2d_sssp_engine_drain(dwg2, s, mesh, 1.0,
                                        compress=compress)
        out[f"path/{int(compress)}"] = fields(
            ds.dist2d_sssp_engine_result(dwg2, s), s)

    wg = graph("engine")
    src = graphs["engine"][4]
    delta = float(graphs["engine/delta"])
    for name, kwargs in (("mesh", dict(mesh=mesh2)),
                         ("grid", dict(grid=(2, 2), compress=True))):
        tel = Telemetry()
        eng = LaneEngine(wg, telemetry=tel, **kwargs)
        out[f"engine/{name}"] = fields(eng.sssp_sweep(src, delta=delta))
        out[f"engine/{name}/plain"] = fields(LaneEngine(wg, **kwargs)
                                             .sssp_sweep(src, delta=delta))
        rec = tel.sweeps[0]
        out[f"engine/{name}/records"] = repr([
            {k: v for k, v in r.as_dict().items() if k != "wall_ms"}
            for r in rec.records])
        out[f"engine/{name}/meta"] = repr((rec.engine, rec.meta))
    return out


@pytest.fixture(scope="module")
def graphs():
    return graph_arrays()


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, graphs):
    """The reference children and the port's ranks, started together on
    first use: ([(future, npz path)], port future)."""
    from concurrent.futures import ThreadPoolExecutor
    tmp = tmp_path_factory.mktemp("dist_sssp")
    gpath = tmp / "graphs.npz"
    flat = {}
    for name, arrs in graphs.items():
        if isinstance(arrs, tuple):
            for f, a in zip(GRAPH_FIELDS + ("sources",), arrs):
                flat[f"{name}/{f}"] = a
        else:
            flat[name] = np.asarray(arrs)
    np.savez(gpath, **flat)
    pool = ThreadPoolExecutor(4)
    port = pool.submit(run_ranks, dist_sssp_rank, 4, graphs, device="cpu")
    shapes = [(k, s if k == "1d" else tuple(s)) for k, s in SHAPES]
    children = []
    for i, case in enumerate(CASES + (None,)):
        # a child per matrix case, and one for the rest
        matrix, extras = [], case is None
        if case is not None:
            name, _, kind_delta = case
            lanes = max(1, len(graphs[name][4]) // 2)
            matrix = [(name, case_delta(name, kind_delta, lanes), lanes,
                       shapes)]
        path = tmp / f"ref{i}.npz"
        code = REF_CODE.format(fields=FIELDS, graphs=str(gpath),
                               graph_fields=GRAPH_FIELDS, matrix=matrix,
                               extras=extras, out=str(path))
        children.append((pool.submit(run_in_subprocess, code, devices=4,
                                     timeout=900, env_extra=U32_ENV), path))
    yield children, port
    pool.shutdown()


@pytest.fixture(scope="module")
def ref(jobs):
    out = {}
    for future, path in jobs[0]:
        assert "REF_DIST_SSSP_OK" in future.result()
        out.update(np.load(path))
    return out


@pytest.fixture(scope="module")
def port(jobs):
    return jobs[1].result()


def assert_run(got: dict, ref: dict, prefix: str, host: dict | None = None):
    """Every field equal to the reference's (and the host engine's) bit for
    bit, the byte meter and the per-step log equal as ints."""
    for f in FIELDS:
        a, b = got[f], ref[f"{prefix}/{f}"]
        assert a.dtype == b.dtype, (prefix, f)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{prefix} {f}")
        if host is not None:
            np.testing.assert_array_equal(got[f], host[f],
                                          err_msg=f"{prefix} host {f}")
    if "exch_bytes" in got:
        assert type(got["exch_bytes"]) is int
        assert got["exch_bytes"] == int(ref[f"{prefix}/exch_bytes"]), prefix
        np.testing.assert_array_equal(
            got["exch_log"], ref[f"{prefix}/exch_log"].astype(np.int64),
            err_msg=f"{prefix} exch_log")
        assert got["exch_bytes"] == int(got["exch_log"].sum()) > 0, prefix


@pytest.mark.parametrize("compress", [False, True], ids=["dense",
                                                         "compressed"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_parity_matrix(port, ref, case, shape, compress):
    kind, s = shape
    prefix = f"{case}/{kind}/{s}/{int(compress)}"
    assert_run(port[prefix], ref, prefix, port[f"{case}/host"])


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_default_delta_dist_is_the_host_width(port, ref, shape):
    kind, s = shape
    key = f"default_delta/{kind}/{s}"
    assert port[key] == port["random3/host_delta"] == float(ref[key])


def test_unit_weight_anchor_matches_dist_msbfs(port, ref):
    for key in ("anchor/msbfs", "anchor/1d", "anchor/2d"):
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(port[key], port["anchor/msbfs"],
                                      err_msg=key)


def test_streaming_enqueue_mid_sweep(port, ref):
    assert_run(port["stream"], ref, "stream", port["stream/host"])


def test_compressed_bytes_track_the_frontier(port, ref):
    """On a path the dense value exchange ships every entry every step,
    the compressed one about one vertex's a step."""
    for c in (0, 1):
        assert_run(port[f"path/{c}"], ref, f"path/{c}")
        np.testing.assert_array_equal(port[f"path/{c}"]["dist"][:, 0],
                                      np.arange(32, dtype=np.float32))
    dense, comp = port["path/0"]["exch_log"], port["path/1"]["exch_log"]
    live = dense > 0
    assert live.sum() >= 16 and (dense[live] == dense[live][0]).all()
    assert comp[live].max() * 2 < dense[live][0]


@pytest.mark.parametrize("name", ["mesh", "grid"])
def test_lane_engine_sssp_sweep_with_telemetry(port, ref, name):
    """``LaneEngine.sssp_sweep`` on a 2-rank mesh (``dist_sssp``) and a 2x2
    grid (``dist2d_sssp``, compressed): the reference's results, the same
    unrecorded, and recorded steps equal to the reference's."""
    key = f"engine/{name}"
    assert_run(port[key], ref, key)
    assert_run(port[f"{key}/plain"], ref, key)
    assert port[f"{key}/records"] == str(ref[f"{key}/records"])
    assert port[f"{key}/meta"] == str(ref[f"{key}/meta"])
    fmt = "compressed" if name == "grid" else "dense"
    assert f"'exch_format': '{fmt}'" in port[f"{key}/records"]


@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (1, 4), (3, 2)])
def test_weighted_partitions_match_reference(graphs, grid):
    """The 1-D slabs at ``pr * pc`` blocks and the 2-D blocks: every array
    equal to the reference's, and ``default_delta_dist`` to the host's."""
    from repro.core.csr import WeightedCSRGraph as JWeighted
    from repro.core.dist_sssp import (
        partition_weighted_graph as ref_1d,
        partition_weighted_graph_2d as ref_2d)

    from repro_torch.core.csr import from_numpy_weighted_graph
    from repro_torch.core.dist_sssp import (default_delta_dist,
                                            partition_weighted_graph,
                                            partition_weighted_graph_2d)
    from repro_torch.traversal.sssp import default_delta
    for name in ("random3", "two11", "path"):
        arrs = graphs[name][:4]
        wg = from_numpy_weighted_graph(*arrs, "cpu")
        jwg = JWeighted(*arrs)
        ndev = grid[0] * grid[1]
        got, want = partition_weighted_graph(wg, ndev), ref_1d(jwg, ndev)
        for f in ("row_ptr", "col_idx", "src_loc", "deg", "weights"):
            np.testing.assert_array_equal(
                getattr(got, f), np.asarray(getattr(want, f)),
                err_msg=f"{name} 1d {f}")
        got2, want2 = partition_weighted_graph_2d(wg, *grid), ref_2d(jwg,
                                                                     *grid)
        np.testing.assert_array_equal(got2.weights,
                                      np.asarray(want2.weights))
        for f in ("row_ptr", "col_loc", "col_gid", "src_loc", "deg"):
            np.testing.assert_array_equal(getattr(got2.g2, f),
                                          np.asarray(getattr(want2.g2, f)))
        assert (got2.n, got2.n_orig) == (want2.n, want2.n_orig)
        for dwg in (got, got2):
            assert default_delta_dist(dwg) == default_delta(wg), name


def test_validation_errors(graphs):
    from repro_torch.core.csr import from_numpy_weighted_graph
    from repro_torch.core.dist_sssp import (_check_partition_1d,
                                            dist_sssp_engine_step,
                                            partition_weighted_graph)

    class FakeMesh:
        def __init__(self, n):
            self.mesh = torch.zeros(n)
    wg = from_numpy_weighted_graph(*graphs["random3"][:4], "cpu")
    dwg = partition_weighted_graph(wg, 2)
    assert _check_partition_1d(dwg, FakeMesh(2)) == 2
    with pytest.raises(ValueError, match="repartition"):
        _check_partition_1d(dwg, FakeMesh(1))
    for bad in (0.0, (1.0, -2.0)):
        with pytest.raises(ValueError, match="delta"):
            dist_sssp_engine_step(dwg, None, FakeMesh(2), bad)


# ---------------------------------------------------------------------------
# On the card: the relax kernels on the blocks of non-square grids
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("grid", [(1, 4), (4, 1), (2, 2)])
def test_relax_kernels_cuda_on_grid_blocks(cuda_device, grid):
    """semiring_relax and relax_fallback on every block of a 1x4, 4x1 and
    2x2 weighted partition against the column block's values (n_x rows,
    fewer than the block's rows on 1x4): each equal to its plain version
    bit for bit."""
    from repro_torch.core.dist_sssp import partition_weighted_graph_2d
    from repro_torch.graph.generator import rmat_weighted_graph
    from repro_torch.kernels.relax_fallback.kernel import relax_fallback_cuda
    from repro_torch.kernels.relax_fallback.ref import relax_fallback_ref
    from repro_torch.kernels.semiring_relax.kernel import semiring_relax_cuda
    from repro_torch.kernels.semiring_relax.ref import semiring_relax_ref
    pr, pc = grid
    wg = rmat_weighted_graph(12, 16, seed=pr, device=cuda_device)
    dwg2 = partition_weighted_graph_2d(wg, pr, pc)
    g2 = dwg2.g2
    rng = np.random.default_rng(pc)
    for d in range(pr * pc):
        blk = dwg2.local(d, cuda_device)
        vals = rng.random((g2.n_x, 8), dtype=np.float32)
        vals[rng.random(vals.shape) < 0.7] = np.inf
        x = torch.from_numpy(vals).to(cuda_device)
        for w in (torch.where(blk.weights <= 0.3, blk.weights, np.inf),
                  torch.where(blk.weights > 0.3, blk.weights, np.inf)):
            acc = semiring_relax_cuda(blk.row_ptr, blk.col_idx, w, x, 8)
            want = semiring_relax_ref(blk.row_ptr[:-1], blk.row_ptr.diff(),
                                      blk.col_idx, w, x, 8)
            assert torch.equal(acc, want), (grid, d)
            got = relax_fallback_cuda(blk.row_ptr, blk.src_idx, blk.col_idx,
                                      w, x, acc.clone(), 8)
            assert torch.equal(got, relax_fallback_ref(
                blk.row_ptr, blk.src_idx, blk.col_idx, w, x, acc.clone(),
                8)), (grid, d)
