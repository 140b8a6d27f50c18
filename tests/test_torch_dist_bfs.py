"""The port's distributed BFS against ``repro.core.dist_bfs``.

``partition_graph`` must give the reference's stacked arrays exactly (at
1, 2 and 4 blocks, on a graph whose vertex count needs padding), and
``dist_bfs`` the reference's parent, depth and layer count for every mode
and root, which also equal the port's serial ``bfs`` and the numpy oracle.

The reference runs once, in a child process with four forced host devices:
``dist_bfs`` on a 4-device mesh and on a 2x2 mesh (all axes flattened),
with its XLA probe, and on a subset with its Pallas probe in interpret
mode; the child checks that these agree and writes one result per case.
The port runs on four gloo ranks (``distributed.ranks.run_ranks``) on a
4-rank mesh, a 2x2 mesh, and 2- and 1-rank sub-meshes, once at each lane
word width (``dist_bfs`` packs a bitmap, not lane words, so both launches
must give the same results). The reference child and both launches start
together. Integer outputs: exact equality.
"""
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.core.csr import from_numpy_graph
from repro_torch.core.dist_bfs import partition_graph
from repro_torch.core.hybrid import bfs
from repro_torch.core.ref import bfs_reference
from repro_torch.distributed.ranks import run_ranks
from repro_torch.graph.generator import (rmat_graph, sample_roots,
                                         uniform_random_graph)

U32_ENV = {"LANE_WORD_BITS": "32", "JAX_ENABLE_X64": "0"}
GRAPHS = ("rmat", "uniform")
MODES = ("hybrid", "topdown", "bottomup")
MESHES = ("4", "2x2", "2", "1")
NDEVS = (1, 2, 4)
NROOTS = 2
# the serial engine's name of each distributed mode
SERIAL_MODE = {"hybrid": "hybrid", "topdown": "topdown",
               "bottomup": "bottomup_simd"}


def port_graph(name):
    if name == "rmat":
        return rmat_graph(9, 8, seed=0, device="cpu")
    return uniform_random_graph(333, 2000, seed=4, device="cpu")


REF_CODE = """
import numpy as np, jax
from repro.core.dist_bfs import dist_bfs, partition_graph
from repro.graph.generator import (rmat_graph, sample_roots,
                                   uniform_random_graph)

devs = np.asarray(jax.devices()[:4])
meshes = {"4": jax.sharding.Mesh(devs, ("data",)),
          "2x2": jax.sharding.Mesh(devs.reshape(2, 2), ("row", "col"))}
out = {}
for gname, g in (("rmat", rmat_graph(9, 8, seed=0)),
                 ("uniform", uniform_random_graph(333, 2000, seed=4))):
    out[f"{gname}/row_ptr"] = np.asarray(g.row_ptr)
    out[f"{gname}/col_idx"] = np.asarray(g.col_idx)
    for nd in (1, 2, 4):
        dg = partition_graph(g, nd)
        for f in ("row_ptr", "col_idx", "src_loc", "deg"):
            out[f"{gname}/part{nd}/{f}"] = np.asarray(getattr(dg, f))
        out[f"{gname}/part{nd}/sizes"] = np.array([dg.n, dg.n_orig,
                                                   dg.m_loc])
    dg = partition_graph(g, 4)
    roots = sample_roots(g, %(nroots)d, seed=1)
    out[f"{gname}/roots"] = np.asarray(roots)
    for mode in ("hybrid", "topdown", "bottomup"):
        for i, r in enumerate(roots):
            got = {}
            for mname, mesh in meshes.items():
                got[mname] = dist_bfs(dg, int(r), mesh, mode)
            if mode != "topdown" and (gname == "rmat" or i == 0):
                got["pallas"] = dist_bfs(dg, int(r), meshes["4"], mode,
                                         probe_impl="pallas")
            for f in ("parent", "depth", "num_layers"):
                want = np.asarray(getattr(got["4"], f))
                for other, res in got.items():
                    assert np.array_equal(np.asarray(getattr(res, f)),
                                          want), (gname, mode, other, f)
                out[f"{gname}/{mode}/{i}/{f}"] = want
np.savez(%(out)r, **out)
print("REF_DIST_BFS_OK")
"""


def dist_bfs_rank(bits):
    """Every rank: ``dist_bfs`` of both graphs, every mode and root, on
    the four meshes, at ``bits``-bit lane words (set before the port's
    engines are imported). Returns rank 0's results, keyed like the
    reference's."""
    import os
    os.environ["LANE_WORD_BITS"] = str(bits)
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.dist_bfs import dist_bfs
    from repro_torch.core.dist_msbfs import host_mesh
    from repro_torch.core.packed import LANE_WORD_BITS
    grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("row", "col"))
    meshes = {"4": host_mesh(4, "cpu"), "2x2": grid, "2": grid["col"],
              "1": init_device_mesh("cpu", (4, 1),
                                    mesh_dim_names=("rest", "data"))["data"]}
    out = {"word_bits": LANE_WORD_BITS}
    for gname in GRAPHS:
        g = port_graph(gname)
        roots = sample_roots(g, NROOTS, seed=1)
        for mname, mesh in meshes.items():
            dg = partition_graph(g, mesh.mesh.numel())
            for mode in MODES:
                for i, r in enumerate(roots):
                    res = dist_bfs(dg, int(r), mesh, mode)
                    for f in ("parent", "depth", "num_layers"):
                        out[f"{gname}/{mname}/{mode}/{i}/{f}"] = getattr(
                            res, f).numpy()
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The reference child and the port's launch at each lane word width,
    started together on first use: ({name: future}, npz path)."""
    from concurrent.futures import ThreadPoolExecutor
    path = tmp_path_factory.mktemp("dist_bfs") / "reference.npz"
    pool = ThreadPoolExecutor(3)
    futures = {"ref": pool.submit(
        run_in_subprocess, REF_CODE % dict(out=str(path), nroots=NROOTS),
        devices=4, env_extra=U32_ENV)}
    for bits in (32, 64):
        futures[bits] = pool.submit(run_ranks, dist_bfs_rank, 4, bits,
                                    device="cpu")
    yield futures, path
    pool.shutdown()


@pytest.fixture(scope="module")
def ref(jobs):
    futures, path = jobs
    assert "REF_DIST_BFS_OK" in futures["ref"].result()
    return dict(np.load(path))


@pytest.fixture(scope="module", params=[32, 64])
def port(request, jobs):
    """The port's ranks at each lane word width."""
    out = jobs[0][request.param].result()
    assert out["word_bits"] == request.param
    return out


@pytest.fixture(scope="module")
def serial():
    """The port's serial bfs and the numpy oracle, per graph, mode and
    root."""
    out = {}
    for gname in GRAPHS:
        g = port_graph(gname)
        rp, ci = g.row_ptr.numpy(), g.col_idx.numpy()
        for i, r in enumerate(sample_roots(g, NROOTS, seed=1)):
            out[gname, "oracle", i] = bfs_reference(rp, ci, int(r))
            for mode in MODES:
                res = bfs(g, int(r), SERIAL_MODE[mode])
                out[gname, mode, i] = (res.parent.numpy(), res.depth.numpy(),
                                       int(res.num_layers))
    return out


@pytest.mark.parametrize("root", range(NROOTS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("gname", GRAPHS)
def test_dist_bfs_matches_reference_and_serial(port, ref, serial, gname,
                                               mesh, mode, root):
    key = f"{gname}/{mesh}/{mode}/{root}"
    want = [ref[f"{gname}/{mode}/{root}/{f}"]
            for f in ("parent", "depth", "num_layers")]
    got = [port[f"{key}/{f}"] for f in ("parent", "depth", "num_layers")]
    for name, a, b in zip(("parent", "depth", "num_layers"), got, want):
        assert a.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=f"{key} {name}")
    parent, depth, layers = serial[gname, mode, root]
    np.testing.assert_array_equal(got[0], parent)
    np.testing.assert_array_equal(got[1], depth)
    assert int(got[2]) == layers
    pref, dref = serial[gname, "oracle", root]
    np.testing.assert_array_equal(got[0], pref)
    np.testing.assert_array_equal(got[1], dref)


@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("gname", GRAPHS)
def test_partition_matches_reference(ref, gname, ndev):
    g = port_graph(gname)
    np.testing.assert_array_equal(g.row_ptr.numpy(), ref[f"{gname}/row_ptr"])
    np.testing.assert_array_equal(g.col_idx.numpy(), ref[f"{gname}/col_idx"])
    dg = partition_graph(g, ndev)
    for f in ("row_ptr", "col_idx", "src_loc", "deg"):
        got, want = getattr(dg, f), ref[f"{gname}/part{ndev}/{f}"]
        assert got.dtype == want.dtype == np.int32, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert [dg.n, dg.n_orig, dg.m_loc] == ref[f"{gname}/part{ndev}/sizes"
                                             ].tolist()
    if gname == "uniform":
        assert dg.n > dg.n_orig          # 333 vertices pad to whole words


def test_dist_graph_block_is_the_partition_row():
    """``DistGraph.local`` moves one block to a device once, as the stacked
    arrays' row, and caches it."""
    g = port_graph("uniform")
    dg = partition_graph(g, 4)
    blk = dg.local(2, "cpu")
    assert blk is dg.local(2, torch.device("cpu"))
    assert blk.base == 2 * dg.n_loc and blk.g.n == dg.n_loc
    np.testing.assert_array_equal(blk.g.row_ptr.numpy(), dg.row_ptr[2])
    np.testing.assert_array_equal(blk.g.col_idx.numpy(), dg.col_idx[2])
    np.testing.assert_array_equal(blk.g.src_idx.numpy(), dg.src_loc[2])
    np.testing.assert_array_equal(blk.deg.numpy(), dg.deg[2])
    # pad slots lie past the block's last row and name the sentinel n
    assert (dg.col_idx[2, dg.row_ptr[2, -1]:] == dg.n).all()


def test_partition_of_the_carried_graph_is_the_same():
    """A graph carried over from host arrays partitions as the generated
    one: partition_graph reads the graph's arrays, not its device."""
    g = port_graph("rmat")
    h = from_numpy_graph(g.row_ptr.numpy(), g.col_idx.numpy(),
                         g.src_idx.numpy(), "cpu")
    a, b = partition_graph(g, 4), partition_graph(h, 4)
    for f in ("row_ptr", "col_idx", "src_loc", "deg"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# On the card: bottom_up_probe on each row block against the global bitmap
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("ndev", [2, 4])
def test_bottom_up_probe_cuda_on_blocks(cuda_device, ndev):
    """The kernel on each block of a partition, as a rank's bottom-up
    layer calls it: bit-equal to its plain version."""
    from repro_torch.core import bitmap
    from repro_torch.kernels.bottom_up_probe.kernel import (
        bottom_up_probe_cuda)
    from repro_torch.kernels.bottom_up_probe.ref import bottom_up_probe_ref
    g = uniform_random_graph(5000, 40000, seed=3, device=cuda_device)
    dg = partition_graph(g, ndev)
    rng = np.random.default_rng(ndev)
    vis = torch.from_numpy(rng.random(dg.n) < 0.4).to(cuda_device)
    fro = torch.from_numpy(rng.random(dg.n) < 0.2).to(cuda_device) & ~vis
    fw = bitmap.pack(fro)
    par = torch.from_numpy(rng.integers(-1, dg.n, dg.n, dtype=np.int32)).to(
        cuda_device)
    for d in range(ndev):
        blk = dg.local(d, cuda_device)
        rows = slice(blk.base, blk.base + dg.n_loc)
        unv, p = (~vis[rows]).contiguous(), par[rows].contiguous()
        got = bottom_up_probe_cuda(blk.g.row_ptr, unv, p, blk.g.col_idx, fw,
                                   8)
        want = bottom_up_probe_ref(blk.g.row_ptr[:-1], blk.deg,
                                   unv.to(torch.int32), p, blk.g.col_idx, fw,
                                   8)
        for a, b in zip(got, want):
            assert torch.equal(a, b), d
