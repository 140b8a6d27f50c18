"""The port's sharded multi-source BFS against ``repro.core.dist_msbfs``.

``dist_msbfs`` over ``partition_graph(g, ndev)`` must give every
``MSBFSResult`` field (parent, depth, num_layers, edges_traversed and the
four traces) of the reference's ``dist_msbfs`` and of the port's host engine
``msbfs_pipelined``, bit for bit, at 32- and 64-bit lane words: on the
reference's property cases (``tests/test_dist_msbfs.py``, through its
``build_case``) with fewer lanes than roots, in the forced modes, on a
stream that enqueues roots mid-sweep, and through early retirement and the
``LayerReadout`` surface. ``run_graph500(batched=True, ndev=2)`` and
``LaneEngine(ndev=2)`` (its boolean and its weighted sweeps) must give
their one-device results.

The reference runs once per word width, in a child process with four
forced host devices (``LANE_WORD_BITS`` and ``JAX_ENABLE_X64`` pinned as
``tests/test_dist2d.py`` pins them), on a 4-device mesh; it checks that a
2x2 mesh gives the same, and writes the case graphs and results. Its
results do not depend on the device count (its own ``test_dist_msbfs.py``
holds ndev 1, 2 and 4 equal), so the port's results at 1, 2 and 4 ranks
and on a 2x2 mesh are each held against that one result. The port runs
once per width on four gloo ranks (``distributed.ranks.run_ranks``, the
width set in each rank before the port is imported), with 2- and 1-rank
sub-meshes, and rank 0 also runs the host engine on the same steps. The
reference children, the port's launches and the entry points' two ranks
start together. Exact equality throughout; lane words are compared as the
reference's unsigned words.
"""
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.distributed.ranks import run_ranks

U64_ENV = {"LANE_WORD_BITS": "64", "JAX_ENABLE_X64": "1"}
U32_ENV = {"LANE_WORD_BITS": "32", "JAX_ENABLE_X64": "0"}
FIELDS = ("parent", "depth", "num_layers", "edges_traversed", "trace_dir",
          "trace_vf", "trace_ef", "trace_eu")
READOUT = ("layer", "capacity", "lane_qidx", "lane_layer", "depth",
           "out_depth", "out_layers")
# the reference's property cases (tests/test_dist_msbfs.py): n, m, seed,
# shape, self_loops, dup_edges
CASES = ((40, 120, 0, "random", False, False),
         (33, 50, 1, "random", True, True),
         (25, 0, 3, "star", True, False),
         (64, 0, 4, "path", False, True),
         (48, 80, 6, "two_components", False, False))
NCASES = len(CASES)
MESHES = ("4", "2x2", "2", "1")
STREAM = dict(scale=8, seed=5, roots=8, lanes=2, ndev=2, enqueue_at=3)

REF_CODE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
sys.path.insert(0, {testdir!r})
from test_msbfs_properties import build_case
from repro.core.dist_msbfs import (
    dist_msbfs, dist_msbfs_engine_enqueue, dist_msbfs_engine_idle,
    dist_msbfs_engine_init, dist_msbfs_engine_readout,
    dist_msbfs_engine_result, dist_msbfs_engine_retire,
    dist_msbfs_engine_step, partition_graph)
from repro.core.packed import LANE_WORD_BITS
from repro.graph.generator import rmat_graph, sample_roots

assert LANE_WORD_BITS == {bits}
CASES = {cases!r}
FIELDS = {fields!r}
devs = np.asarray(jax.devices()[:4])
mesh4 = Mesh(devs, ("data",))
out = {{}}


def put(prefix, res):
    for f in FIELDS:
        out[f"{{prefix}}/{{f}}"] = np.asarray(getattr(res, f))


def put_readout(prefix, ro):
    for f in {readout!r}:
        out[f"{{prefix}}/{{f}}"] = np.asarray(getattr(ro, f))


for i, (n, m, seed, shape, self_loops, dup) in enumerate(CASES):
    g, roots = build_case(n, m, seed, shape, self_loops, dup)
    for f in ("row_ptr", "col_idx", "src_idx"):
        out[f"case{{i}}/graph/{{f}}"] = np.asarray(getattr(g, f))
    out[f"case{{i}}/roots"] = np.asarray(roots, np.int32)
    lanes = max(1, len(roots) // 2)   # lanes < R: the queue refills
    res = dist_msbfs(partition_graph(g, 4), jnp.asarray(roots, jnp.int32),
                     mesh4, "hybrid", lanes=lanes)
    put(f"case{{i}}", res)
    if i == 0:
        grid = dist_msbfs(partition_graph(g, 4),
                          jnp.asarray(roots, jnp.int32),
                          Mesh(devs.reshape(2, 2), ("row", "col")), "hybrid",
                          lanes=lanes)
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(grid, f)),
                                  np.asarray(getattr(res, f))), f

g = rmat_graph(8, 8, seed=2)
roots = jnp.asarray(sample_roots(g, 6, seed=3), jnp.int32)
for mode in ("topdown", "bottomup"):
    put(f"mode/{{mode}}", dist_msbfs(partition_graph(g, 4), roots, mesh4,
                                     mode, lanes=4))

S = {stream!r}
g = rmat_graph(S["scale"], 8, seed=S["seed"])
roots = sample_roots(g, S["roots"], seed=S["seed"] + 1)
dg = partition_graph(g, S["ndev"])
mesh = Mesh(devs[:S["ndev"]], ("data",))
half = S["roots"] // 2
state = dist_msbfs_engine_init(dg, mesh, capacity=S["roots"],
                               lanes=S["lanes"])
state = dist_msbfs_engine_enqueue(state, roots[:half])
steps = 0
while steps < S["enqueue_at"] or not dist_msbfs_engine_idle(state):
    state = dist_msbfs_engine_step(dg, state, mesh, "hybrid")
    steps += 1
    if steps == S["enqueue_at"]:           # mid-sweep arrivals
        put_readout("stream/readout", dist_msbfs_engine_readout(dg, state))
        state = dist_msbfs_engine_enqueue(state, roots[half:])
    assert steps < 500
put("stream", dist_msbfs_engine_result(dg, state, mesh))
out["stream/steps"] = np.asarray(steps)

state = dist_msbfs_engine_init(dg, mesh, capacity=S["roots"],
                               lanes=S["lanes"])
state = dist_msbfs_engine_enqueue(state, roots)
for _ in range(2):
    state = dist_msbfs_engine_step(dg, state, mesh, "hybrid")
state = dist_msbfs_engine_retire(dg, state, np.array([True, False]))
put_readout("retire/readout", dist_msbfs_engine_readout(dg, state))
while not dist_msbfs_engine_idle(state):
    state = dist_msbfs_engine_step(dg, state, mesh, "hybrid")
put("retire", dist_msbfs_engine_result(dg, state, mesh))
put_readout("retire/final", dist_msbfs_engine_readout(dg, state))
np.savez({out!r}, **out)
print("REF_DIST_MSBFS_OK")
"""


def _fields(res) -> dict:
    return {f: getattr(res, f).numpy() for f in FIELDS}


def _readout(ro) -> dict:
    return {f: np.asarray(getattr(ro, f)) for f in READOUT}


def dist_msbfs_rank(bits, cases):
    """Every rank, at ``bits``-bit lane words (set before the port is
    imported): the sharded engine on the reference's cases at 4 ranks, a
    2x2 mesh and 2- and 1-rank sub-meshes, the forced modes, the stream
    and the retirement runs; rank 0 also runs the host engine on the same
    inputs and steps. Returns rank 0's results."""
    import os
    os.environ["LANE_WORD_BITS"] = str(bits)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import dist_msbfs as dm
    from repro_torch.core import msbfs as ms
    from repro_torch.core.csr import from_numpy_graph
    from repro_torch.core.packed import LANE_WORD_BITS
    from repro_torch.graph.generator import rmat_graph, sample_roots
    host = dist.get_rank() == 0
    grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("row", "col"))
    meshes = {"4": dm.host_mesh(4, "cpu"), "2x2": grid, "2": grid["col"],
              "1": init_device_mesh("cpu", (4, 1),
                                    mesh_dim_names=("rest", "data"))["data"]}
    out = {"word_bits": LANE_WORD_BITS}
    for i, (row_ptr, col_idx, src_idx, roots) in enumerate(cases):
        g = from_numpy_graph(row_ptr, col_idx, src_idx, "cpu")
        lanes = max(1, len(roots) // 2)
        for mname, mesh in meshes.items():
            dg = dm.partition_graph(g, mesh.mesh.numel())
            out[f"case{i}/{mname}"] = _fields(dm.dist_msbfs(
                dg, roots, mesh, "hybrid", lanes=lanes))
        if host:
            out[f"case{i}/host"] = _fields(ms.msbfs_pipelined(
                g, roots, "hybrid", lanes=lanes))

    g = rmat_graph(8, 8, seed=2, device="cpu")
    roots = sample_roots(g, 6, seed=3)
    for mode in ("topdown", "bottomup"):
        out[f"mode/{mode}"] = _fields(dm.dist_msbfs(
            dm.partition_graph(g, 4), roots, meshes["4"], mode, lanes=4))
        if host:
            out[f"mode/{mode}/host"] = _fields(ms.msbfs_pipelined(
                g, roots, mode, lanes=4))

    s = STREAM
    g = rmat_graph(s["scale"], 8, seed=s["seed"], device="cpu")
    roots = sample_roots(g, s["roots"], seed=s["seed"] + 1)
    dg = dm.partition_graph(g, s["ndev"])
    mesh = meshes[str(s["ndev"])]
    half = s["roots"] // 2
    engines = {"dist": (
        lambda: dm.dist_msbfs_engine_init(dg, mesh, s["roots"], s["lanes"]),
        lambda st: dm.dist_msbfs_engine_step(dg, st, mesh, "hybrid"),
        lambda st: dm.dist_msbfs_engine_readout(dg, st),
        lambda st, mask: dm.dist_msbfs_engine_retire(dg, st, mask),
        lambda st: dm.dist_msbfs_engine_result(dg, st, mesh))}
    if host:
        engines["host"] = (
            lambda: ms.msbfs_engine_init(g, s["roots"], s["lanes"]),
            lambda st: ms.msbfs_engine_step(g, st, "hybrid"),
            ms.msbfs_engine_readout,
            lambda st, mask: ms.msbfs_engine_retire(g, st, mask),
            lambda st: ms.msbfs_engine_result(g, st))
    for name, (init, step, readout, retire, result) in engines.items():
        state = ms.msbfs_engine_enqueue(init(), roots[:half])
        steps = 0
        while steps < s["enqueue_at"] or not ms.msbfs_engine_idle(state):
            state = step(state)
            steps += 1
            if steps == s["enqueue_at"]:
                out[f"stream/readout/{name}"] = _readout(readout(state))
                state = ms.msbfs_engine_enqueue(state, roots[half:])
        out[f"stream/{name}"] = _fields(result(state))
        out[f"stream/steps/{name}"] = steps

        state = ms.msbfs_engine_enqueue(init(), roots)
        for _ in range(2):
            state = step(state)
        state = retire(state, np.array([True, False]))
        out[f"retire/readout/{name}"] = _readout(readout(state))
        while not ms.msbfs_engine_idle(state):
            state = step(state)
        out[f"retire/{name}"] = _fields(result(state))
        out[f"retire/final/{name}"] = _readout(readout(state))
    return out


def entry_points_rank():
    """Two ranks at 32-bit lane words: run_graph500(batched=True, ndev=2)
    and LaneEngine(ndev=2) next to their one-device forms, on the same
    graph and roots."""
    import os
    os.environ["LANE_WORD_BITS"] = "32"
    from repro_torch.analytics import LaneEngine, khop_neighborhood
    from repro_torch.graph.generator import (rmat_weighted_graph,
                                             sample_roots)
    from repro_torch.graph.graph500 import run_graph500
    from repro_torch.obs import Telemetry
    out = {}
    wg = rmat_weighted_graph(8, 8, 1, device="cpu")
    g = wg.csr
    for ndev in (2, 1):
        res = run_graph500(8, 8, num_roots=20, seed=1, graph=g,
                           batched=True, lanes=8, ndev=ndev, validate=True)
        out[f"graph500/{ndev}"] = dict(
            roots=res.roots, traversed=res.traversed, lanes=res.lanes,
            ndev=res.ndev, mode=res.mode)
    roots = sample_roots(g, 12, seed=4)
    one = LaneEngine(g, lanes=8)
    sharded = LaneEngine(wg, ndev=2, lanes=8)
    out["engine/ndev"] = sharded.ndev
    for name, eng in (("one", one), ("two", sharded)):
        out[f"engine/{name}"] = _fields(eng.sweep(roots, derive_parents=True))
        khop = khop_neighborhood(eng, roots, 2)
        out[f"khop/{name}"] = (khop.member_mask(), khop.meta.ndev)
    tel = Telemetry()
    recorded = LaneEngine(g, ndev=2, lanes=8, telemetry=tel)
    out["engine/recorded"] = _fields(recorded.sweep(roots))
    out["engine/records"] = len(tel.sweeps[0].records)
    # the weighted sweep of the same engine runs the sharded SSSP engine
    for name, eng in (("one", LaneEngine(wg, lanes=8)), ("two", sharded)):
        res = eng.sssp_sweep(roots[:4])
        out[f"sssp/{name}"] = {f: getattr(res, f).numpy()
                               for f in res._fields}
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, cases):
    """Every launch of the module, started together on first use: at each
    width the reference child, (future, npz path), and the port's ranks;
    the entry points' ranks. {("ref" | "port", bits) | "entry": ...}."""
    import os
    from concurrent.futures import ThreadPoolExecutor
    testdir = os.path.dirname(os.path.abspath(__file__))
    pool = ThreadPoolExecutor(5)
    jobs = {}
    for bits in (32, 64):
        path = tmp_path_factory.mktemp(f"dist_msbfs{bits}") / "ref.npz"
        code = REF_CODE.format(testdir=testdir, bits=bits, cases=CASES,
                               fields=FIELDS, readout=READOUT, stream=STREAM,
                               out=str(path))
        jobs["ref", bits] = (pool.submit(run_in_subprocess, code, devices=4,
                                         env_extra=U64_ENV if bits == 64
                                         else U32_ENV), path)
        jobs["port", bits] = pool.submit(run_ranks, dist_msbfs_rank, 4, bits,
                                         cases, device="cpu")
    jobs["entry"] = pool.submit(run_ranks, entry_points_rank, 2,
                                device="cpu")
    yield jobs
    pool.shutdown()


@pytest.fixture(scope="module")
def cases():
    """The property cases' graphs and roots, built by the reference's
    ``build_case``, as host arrays."""
    from test_msbfs_properties import build_case
    out = []
    for case in CASES:
        g, roots = build_case(*case)
        out.append(tuple(np.asarray(a) for a in (g.row_ptr, g.col_idx,
                                                 g.src_idx))
                   + (np.asarray(roots, np.int32),))
    return out


@pytest.fixture(scope="module", params=[32, 64])
def bits(request):
    return request.param


@pytest.fixture(scope="module")
def ref(bits, jobs, cases):
    future, path = jobs["ref", bits]
    assert "REF_DIST_MSBFS_OK" in future.result()
    out = dict(np.load(path))
    for i, case in enumerate(cases):    # the child built the same cases
        for name, a in zip(("row_ptr", "col_idx", "src_idx"), case):
            np.testing.assert_array_equal(a, out[f"case{i}/graph/{name}"])
        np.testing.assert_array_equal(case[3], out[f"case{i}/roots"])
    return out


@pytest.fixture(scope="module")
def port(bits, jobs):
    out = jobs["port", bits].result()
    assert out["word_bits"] == bits
    return out


@pytest.fixture(scope="module")
def entry_points(jobs):
    return jobs["entry"].result()


def ref_fields(ref: dict, prefix: str) -> dict:
    return {f: ref[f"{prefix}/{f}"] for f in FIELDS}


def assert_fields(got: dict, want: dict, what):
    for f in FIELDS:
        assert got[f].dtype == np.int32, (what, f)
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{what} {f}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", range(NCASES))
def test_property_cases_match_reference_and_host(port, ref, case, mesh):
    got = port[f"case{case}/{mesh}"]
    assert_fields(got, ref_fields(ref, f"case{case}"), f"case{case}")
    assert_fields(got, port[f"case{case}/host"], f"case{case} host")


@pytest.mark.parametrize("mode", ["topdown", "bottomup"])
def test_forced_modes_match_reference_and_host(port, ref, mode):
    assert_fields(port[f"mode/{mode}"], ref_fields(ref, f"mode/{mode}"),
                  mode)
    assert_fields(port[f"mode/{mode}"], port[f"mode/{mode}/host"], mode)


@pytest.mark.parametrize("run", ["stream", "retire"])
def test_stepping_api_matches_reference_and_host(port, ref, run):
    """The mid-sweep enqueue stream and early retirement: the results and
    the read-outs (after the enqueue step, after the retirement, at the
    end) equal the reference's and the host engine's."""
    assert_fields(port[f"{run}/dist"], ref_fields(ref, run), run)
    assert_fields(port[f"{run}/dist"], port[f"{run}/host"], f"{run} host")
    if run == "stream":
        assert port["stream/steps/dist"] == int(ref["stream/steps"])
        assert port["stream/steps/host"] == int(ref["stream/steps"])
    stages = ("readout",) if run == "stream" else ("readout", "final")
    for stage in stages:
        for name in ("dist", "host"):
            got = port[f"{run}/{stage}/{name}"]
            cap = int(got["capacity"])
            for f in READOUT:
                a, b = got[f], ref[f"{run}/{stage}/{f}"]
                if f.startswith("out_"):
                    # not the trailing column: the reference's scatter
                    # target for lanes that did not finish, which neither
                    # port engine writes
                    a, b = a[..., :cap], b[..., :cap]
                np.testing.assert_array_equal(
                    a, b, err_msg=f"{run} {stage} {name} {f}")


def test_run_graph500_sharded_equals_one_device(entry_points):
    two, one = entry_points["graph500/2"], entry_points["graph500/1"]
    assert two["ndev"] == 2 and one["ndev"] == 1
    for key in ("roots", "traversed", "lanes", "mode"):
        assert two[key] == one[key], key


def test_lane_engine_sharded_equals_one_device(entry_points):
    assert entry_points["engine/ndev"] == 2
    assert_fields(entry_points["engine/two"], entry_points["engine/one"],
                  "sweep")
    (two, meta_two), (one, meta_one) = (entry_points["khop/two"],
                                        entry_points["khop/one"])
    np.testing.assert_array_equal(two, one)
    assert (meta_two, meta_one) == (2, 1)
    # a recorded sweep steps the same engine: the same depths and traces
    got, want = entry_points["engine/recorded"], entry_points["engine/one"]
    for f in FIELDS[1:]:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert entry_points["engine/records"] > 0
    got, want = entry_points["sssp/two"], entry_points["sssp/one"]
    for f, a in want.items():
        np.testing.assert_array_equal(got[f], a, err_msg=f"sssp {f}")


def test_host_engine_shapes_and_guards():
    """In this process, without a group: the guards that need none."""
    from repro_torch.analytics import LaneEngine
    from repro_torch.core import dist_msbfs as dm
    from repro_torch.graph.generator import rmat_graph
    g = rmat_graph(6, 4, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        LaneEngine(g, ndev=2)
    with pytest.raises(RuntimeError, match="run_ranks"):
        dm.host_mesh(1, "cpu")
    dg = dm.partition_graph(g, 2)
    assert dg.ndev == 2 and dg.n == 64 and dg.n_loc == 32
    assert torch.equal(dm.partition_graph(g, 1).local(0, "cpu").g.row_ptr,
                       g.row_ptr)


# ---------------------------------------------------------------------------
# On the card: B3 and both forms of X1 on row blocks; one NCCL rank
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("w", [1, 2, 3])
def test_lane_kernels_cuda_on_blocks(cuda_device, w):
    """msbfs_probe and both forms of segment_or on each block of a 4-way
    partition against the whole [n, W] frontier, as a rank's packed step
    calls them: each equal to its plain version."""
    from repro_torch.core.dist_bfs import partition_graph
    from repro_torch.graph.generator import rmat_graph
    from repro_torch.kernels.msbfs_probe.kernel import msbfs_probe_cuda
    from repro_torch.kernels.msbfs_probe.ref import msbfs_probe_ref
    from repro_torch.kernels.segment_or.kernel import segment_or_rows_cuda
    from repro_torch.kernels.segment_or.ref import segment_or_rows_ref
    g = rmat_graph(12, 16, seed=w, device=cuda_device)
    dg = partition_graph(g, 4)
    rng = np.random.default_rng(w)

    def words():
        return torch.from_numpy(rng.integers(0, 2 ** 32, (dg.n, w),
                                             dtype=np.uint32).view(np.int32))
    vis = (words() & words()).to(cuda_device)
    fro = (words() & words()).to(cuda_device) & ~vis
    sel = torch.full((w,), -1, dtype=torch.int32, device=cuda_device)
    for d in range(4):
        blk = dg.local(d, cuda_device)
        bg = blk.g
        need = (~vis[blk.base:blk.base + dg.n_loc]).contiguous()
        acc = msbfs_probe_cuda(bg.row_ptr, need, bg.col_idx, fro, 8)
        assert torch.equal(acc, msbfs_probe_ref(bg.row_ptr[:-1], blk.deg,
                                                need, bg.col_idx, fro, 8))
        found = acc & need
        residue = (((need & ~found) != 0).any(dim=-1)
                   & (blk.deg > 8)).to(torch.int32)
        for args in ((bg.row_ptr, bg.col_idx, fro, need, None, found,
                      residue, 8),
                     (bg.row_ptr, bg.col_idx, fro, need, sel, None, None,
                      0)):
            assert torch.equal(segment_or_rows_cuda(*args),
                               segment_or_rows_ref(*args)), d


def nccl_rank(graph_path):
    """One NCCL rank: the sharded sweep and dist_bfs against the host
    engines on the card."""
    from repro_torch.core import dist_msbfs as dm
    from repro_torch.core.dist_bfs import dist_bfs
    from repro_torch.core.hybrid import bfs
    from repro_torch.core.msbfs import msbfs_pipelined
    from repro_torch.distributed.ranks import load_graph, rank_device
    from repro_torch.graph.generator import sample_roots
    g = load_graph(graph_path, rank_device())
    mesh = dm.host_mesh(1)
    dg = dm.partition_graph(g, 1)
    roots = sample_roots(g, 40, seed=1)
    got = dm.dist_msbfs(dg, roots, mesh, lanes=32)
    want = msbfs_pipelined(g, roots, lanes=32)
    same = all(torch.equal(getattr(got, f), getattr(want, f))
               for f in FIELDS)
    r = int(roots[0])
    one, ser = dist_bfs(dg, r, mesh), bfs(g, r)
    return same and torch.equal(one.parent, ser.parent) and torch.equal(
        one.depth, ser.depth)


def test_one_nccl_rank_equals_host_engines(cuda_device, tmp_path):
    from repro_torch.distributed.ranks import save_graph
    from repro_torch.graph.generator import rmat_graph
    path = tmp_path / "graph.npz"
    save_graph(rmat_graph(12, 16, seed=0, device=cuda_device), path)
    assert run_ranks(nccl_rank, 1, str(path)) is True
