"""The port's value codec and MIN exchange against the JAX package's.

``repro_torch.distributed.compression``'s value codec (``values_finite``,
``compress_values``, ``decompress_values``) and the MIN side of
``repro_torch.core.exchange`` (``allreduce_min``, ``gather_values``,
``exchange_expand_values``, ``exchange_reduce_min``) get the same seeded
float32 values as ``repro.distributed.compression`` and
``repro.core.exchange``. Outputs must be equal bit for bit, and byte counts
equal as ints. The grid helpers the 2-D engines take their groups from
(``grid_comm``, ``grid_sum``) are checked on a 2x2 mesh and on 1x2
sub-meshes of four ranks.

The reference runs once, in a child process with four forced host devices,
under ``shard_map`` on a 4-device ``("data",)`` mesh and a 2x2 ``("row",
"col")`` mesh. The port runs once on four gloo ranks
(``distributed.ranks.run_ranks``) with the same meshes as ``DeviceMesh``es.
Both start together on first use. The codec is local, so the port's codec
runs in this process.
"""
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.distributed.compression import (compress_values,
                                                 decompress_values,
                                                 sparse_budget,
                                                 values_finite)
from repro_torch.distributed.ranks import run_ranks

CODEC_CASES = ("finite_at_0", "over_budget", "all_inf", "two_d", "zeros")
GATHER_CASES = ("sparse", "one_dense", "all_inf")
MESHES = ("1d", "2x2")
NDEV = 4
ROWS, LANES = 8, 2
INF = np.float32(np.inf)


def random_values(rng, shape, count):
    """``count`` finite values (some of them 0) at random flat positions of
    an all-inf array."""
    flat = np.full(int(np.prod(shape)), INF, np.float32)
    pos = rng.choice(flat.size, count, replace=False)
    vals = rng.random(count, dtype=np.float32) * 10
    vals[::3] = 0.0
    flat[pos] = vals
    return flat.reshape(shape)


def codec_inputs():
    """name -> (values, budget)."""
    rng = np.random.default_rng(7)
    at0 = random_values(rng, (40,), 4)
    at0[0] = 2.5
    zeros = np.full(20, INF, np.float32)
    zeros[[0, 7, 19]] = 0.0
    return {
        "finite_at_0": (at0, sparse_budget(40)),
        "over_budget": (random_values(rng, (40,), 15), sparse_budget(40)),
        "all_inf": (np.full(12, INF, np.float32), sparse_budget(12)),
        "two_d": (random_values(rng, (6, 4), 5), sparse_budget(24)),
        "zeros": (zeros, sparse_budget(20)),
    }


def gather_inputs():
    """name -> values [NDEV, ROWS, LANES], one slice per rank. ``sparse``:
    rank d has d + 1 finite values (the budget of 16 entries is 4), rank
    0's at flat index 0; ``one_dense``: rank 2 has 10, so every group
    holding it ships dense."""
    rng = np.random.default_rng(101)
    shape = (ROWS, LANES)
    sparse = np.stack([random_values(rng, shape, d + 1)
                       for d in range(NDEV)])
    sparse[0, 0, 0] = 1.25
    dense = np.stack([random_values(rng, shape, 10 if d == 2 else 2)
                      for d in range(NDEV)])
    assert 2 <= sparse_budget(ROWS * LANES) < 10
    return {"sparse": sparse, "one_dense": dense,
            "all_inf": np.full((NDEV,) + shape, INF, np.float32)}


def write_inputs(path):
    arrays = {}
    for name, (vals, budget) in codec_inputs().items():
        arrays[f"codec/{name}"] = vals
        arrays[f"budget/{name}"] = np.asarray(budget)
    for name, vals in gather_inputs().items():
        arrays[f"gather/{name}"] = vals
    np.savez(path, **arrays)


REF_CODE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import compat
from repro.core.exchange import (allreduce_min, exchange_expand_values,
                                 exchange_reduce_min, gather_values)
from repro.distributed.compression import (compress_values,
                                           decompress_values, values_finite)

inp = dict(np.load({inputs!r}))
devs = np.asarray(jax.devices()[:4])
MESHES = {{"1d": (Mesh(devs, ("data",)), "data"),
           "2x2": (Mesh(devs.reshape(2, 2), ("row", "col")), "col")}}
out = {{}}


def per_device(fn, mesh, vals):
    axes = tuple(mesh.axis_names)

    def body(x):
        a, b = fn(x[0])
        return a[None], jnp.reshape(b, (1,))
    f = compat.shard_map(body, mesh=mesh, in_specs=(P(axes),),
                         out_specs=(P(axes), P(axes)), check_vma=False)
    a, b = jax.jit(f)(jnp.asarray(vals))
    return np.asarray(a), np.asarray(b)


for key in [k for k in inp if k.startswith("codec/")]:
    name = key.split("/")[-1]
    vals = inp[key]
    budget = int(inp[f"budget/{{name}}"])
    idx, pay, cnt = jax.jit(compress_values, static_argnums=1)(
        jnp.asarray(vals), budget)
    out[f"{{key}}/idx"] = np.asarray(idx)
    out[f"{{key}}/payload"] = np.asarray(pay)
    out[f"{{key}}/count"] = np.asarray(cnt)
    out[f"{{key}}/finite"] = np.asarray(values_finite(jnp.asarray(vals)))
    out[f"{{key}}/decompressed"] = np.asarray(
        decompress_values(idx, pay, vals.size))
for key in [k for k in inp if k.startswith("gather/")]:
    for mname, (mesh, axis) in MESHES.items():
        for compress in (False, True):
            a, b = per_device(
                lambda x: gather_values(x, axis, compress), mesh, inp[key])
            out[f"{{key}}/{{mname}}/{{int(compress)}}/stacked"] = a
            out[f"{{key}}/{{mname}}/{{int(compress)}}/bytes"] = b
            if mname == "2x2":
                a, b = per_device(
                    lambda x: exchange_expand_values(x, "row", compress),
                    mesh, inp[key])
                out[f"{{key}}/expand/{{int(compress)}}"] = a
                out[f"{{key}}/expand_bytes/{{int(compress)}}"] = b
                a, b = per_device(
                    lambda x: exchange_reduce_min(x, "col", compress), mesh,
                    inp[key])
                out[f"{{key}}/reduce/{{int(compress)}}"] = a
                out[f"{{key}}/reduce_bytes/{{int(compress)}}"] = b
    a, _ = per_device(lambda x: (allreduce_min(x, ("data",)), jnp.int32(0)),
                      MESHES["1d"][0], inp[key])
    out[f"{{key}}/allreduce_min"] = a
np.savez({out!r}, **out)
print("REF_EXCHANGE_VALUES_OK")
"""


def exchange_values_rank(inputs_path):
    """Every rank: gather_values (dense and compressed) along the 1-D mesh
    and the 2x2 mesh's "col" axis, the two 2-D value exchanges, the MIN
    all-reduce; the grid helpers on the 2x2 grid and on two 1x2 sub-grids.
    Returns every rank's outputs (rank 0's return value)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core.dist_msbfs import host_mesh
    from repro_torch.core.exchange import (allreduce_min,
                                           exchange_expand_values,
                                           exchange_reduce_min,
                                           gather_values, grid_comm,
                                           grid_sum, mesh_comm)
    rank = dist.get_rank()
    inp = dict(np.load(inputs_path))
    grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("row", "col"))
    comms = {"1d": mesh_comm(host_mesh(NDEV, "cpu")),
             "2x2": mesh_comm(grid, "col")}
    gc = grid_comm(grid)
    out = {}
    for key in [k for k in inp if k.startswith("gather/")]:
        own = torch.from_numpy(inp[key][rank])
        for mname, comm in comms.items():
            for compress in (False, True):
                st, nbytes = gather_values(own, comm, compress)
                out[f"{key}/{mname}/{int(compress)}/stacked"] = st.numpy()
                out[f"{key}/{mname}/{int(compress)}/bytes"] = nbytes
            for compress in (False, True) if mname == "2x2" else ():
                v, b = exchange_expand_values(own, gc.row, compress)
                out[f"{key}/expand/{int(compress)}"] = v.numpy()
                out[f"{key}/expand_bytes/{int(compress)}"] = b
                v, b = exchange_reduce_min(own, gc.col, compress)
                out[f"{key}/reduce/{int(compress)}"] = v.numpy()
                out[f"{key}/reduce_bytes/{int(compress)}"] = b
        out[f"{key}/allreduce_min"] = allreduce_min(own,
                                                    comms["1d"]).numpy()
    x = torch.tensor([rank + 1, 10 * (rank + 1)], dtype=torch.int64)
    sub = grid_comm(init_device_mesh("cpu", (2, 1, 2), mesh_dim_names=(
        "rest", "row", "col"))["row", "col"])
    out["grid"] = dict(i=gc.i, j=gc.j, pr=gc.pr, pc=gc.pc,
                       world=gc.world is not None,
                       sum=grid_sum(x, gc).tolist())
    out["sub"] = dict(i=sub.i, j=sub.j, pr=sub.pr, pc=sub.pc,
                      world=sub.world is not None,
                      sum=grid_sum(x, sub).tolist())
    ranks = [None] * NDEV
    dist.all_gather_object(ranks, out)
    return ranks


@pytest.fixture(scope="module")
def inputs_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("exchange_values") / "inputs.npz"
    write_inputs(path)
    return path


@pytest.fixture(scope="module")
def jobs(inputs_path):
    """The reference child and the port's ranks, started together on
    first use: (reference future, npz path, port future)."""
    from concurrent.futures import ThreadPoolExecutor
    path = inputs_path.parent / "reference.npz"
    pool = ThreadPoolExecutor(2)
    yield (pool.submit(run_in_subprocess,
                       REF_CODE.format(inputs=str(inputs_path),
                                       out=str(path)), devices=NDEV),
           path, pool.submit(run_ranks, exchange_values_rank, NDEV,
                             str(inputs_path), device="cpu"))
    pool.shutdown()


@pytest.fixture(scope="module")
def ref(jobs):
    future, path, _ = jobs
    assert "REF_EXCHANGE_VALUES_OK" in future.result()
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port(jobs):
    return jobs[2].result()


def same_values(got, want, what=""):
    """float32 arrays equal bit for bit (so -0.0, 0.0 and inf too)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == np.float32 == want.dtype, what
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                  err_msg=str(what))


@pytest.mark.parametrize("name", CODEC_CASES)
def test_value_codec_matches_reference(ref, name):
    vals, budget = codec_inputs()[name]
    key = f"codec/{name}"
    t = torch.from_numpy(vals)
    idx, payload, count = compress_values(t, budget)
    assert idx.dtype == torch.int32 and count.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), ref[f"{key}/idx"])
    same_values(payload, ref[f"{key}/payload"], key)
    assert int(count) == int(ref[f"{key}/count"])
    assert int(values_finite(t)) == int(ref[f"{key}/finite"])
    flat = decompress_values(idx, payload, vals.size)
    same_values(flat, ref[f"{key}/decompressed"], key)
    if int(count) <= budget:        # the codec round-trips within budget
        same_values(flat, vals.reshape(-1), key)


def test_value_codec_budget_bounds():
    t = torch.zeros(8)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="budget"):
            compress_values(t, bad)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("compress", [False, True], ids=["dense",
                                                         "compressed"])
@pytest.mark.parametrize("name", GATHER_CASES)
def test_gather_values_matches_reference(ref, port, name, compress, mesh):
    key = f"gather/{name}/{mesh}/{int(compress)}"
    for rank in range(NDEV):
        same_values(port[rank][f"{key}/stacked"],
                    ref[f"{key}/stacked"][rank], (key, rank))
        nbytes = port[rank][f"{key}/bytes"]
        assert type(nbytes) is int and nbytes == int(ref[f"{key}/bytes"][rank])


@pytest.mark.parametrize("compress", [False, True], ids=["dense",
                                                         "compressed"])
@pytest.mark.parametrize("name", GATHER_CASES)
def test_two_d_value_exchanges_match_reference(ref, port, name, compress):
    """Expand along "row" (concatenate the grid column's slices in grid-row
    order) and MIN-fold along "col", with their byte counts; the MIN
    all-reduce over the 1-D mesh."""
    key = f"gather/{name}"
    c = int(compress)
    for rank in range(NDEV):
        for part in ("expand", "reduce"):
            same_values(port[rank][f"{key}/{part}/{c}"],
                        ref[f"{key}/{part}/{c}"][rank], (key, part, rank))
            assert (port[rank][f"{key}/{part}_bytes/{c}"]
                    == int(ref[f"{key}/{part}_bytes/{c}"][rank]))
        same_values(port[rank][f"{key}/allreduce_min"],
                    ref[f"{key}/allreduce_min"][rank], (key, rank))


@pytest.mark.parametrize("which", ["grid", "sub"])
def test_grid_comm_and_grid_sum(port, which):
    """Rank r of the 2x2 grid sits at (r // 2, r % 2) and the grid spans
    the process group; on the 1x2 sub-grids (ranks {0, 1} and {2, 3}) it
    sits at (0, r % 2), the sub-grid does not span the group, and the sum
    goes over "col" and then "row", over the sub-grid's ranks only."""
    for rank in range(NDEV):
        got = port[rank][which]
        if which == "grid":
            want = dict(i=rank // 2, j=rank % 2, pr=2, pc=2, world=True,
                        sum=[10, 100])
        else:
            pair = [rank - rank % 2 + 1, rank - rank % 2 + 2]
            want = dict(i=0, j=rank % 2, pr=1, pc=2, world=False,
                        sum=[sum(pair), 10 * sum(pair)])
        assert got == want, (which, rank)
