"""The port's frontier-word codec and exchange against the JAX package's.

``repro_torch.distributed.compression`` (the sparse word codec) and
``repro_torch.core.exchange`` (``gather_words``, ``exchange_expand``,
``exchange_reduce_or``, ``allreduce_or``) get the same seeded words as
``repro.distributed.compression`` and ``repro.core.exchange``, at 32- and
64-bit words (uint32 / uint64 in the reference, their int32 / int64 bit
patterns in the port). Outputs must be equal bit for bit, and byte counts
equal as ints.

The reference runs once, in a child process with four forced host devices
and ``JAX_ENABLE_X64=1`` (its uint64 words need it), under ``shard_map``
on a 4-device ``("data",)`` mesh and a 2x2 ``("row", "col")`` mesh. The
port runs once on four gloo ranks (``distributed.ranks.run_ranks``) with
the same meshes as ``DeviceMesh``es. Each writes or returns every rank's
outputs, and each test holds one case. The codec is local, so the port's
codec runs in this process.
"""
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.core.dist_msbfs import host_mesh
from repro_torch.distributed.compression import (DENSE_THRESHOLD,
                                                 compress_words,
                                                 decompress_words,
                                                 sparse_budget, wire_bytes,
                                                 words_nnz)
from repro_torch.distributed.ranks import run_ranks

X64_ENV = {"LANE_WORD_BITS": "64", "JAX_ENABLE_X64": "1"}
BITS = (32, 64)
CODEC_CASES = ("top_bit_at_0", "over_budget", "all_zero", "two_d")
GATHER_CASES = ("sparse", "one_dense", "all_zero")
MESHES = ("1d", "2x2")
WIRE_COUNTS = (0, 3, 8, 9, 40)
NDEV = 4
ROWS, WORDS = 16, 2


def unsigned(bits):
    return np.uint32 if bits == 32 else np.uint64


def signed(a: np.ndarray) -> torch.Tensor:
    """Unsigned reference words as the port's signed bit patterns."""
    view = np.int32 if a.dtype == np.uint32 else np.int64
    return torch.from_numpy(np.ascontiguousarray(a).view(view))


def random_words(rng, bits, shape, count):
    """``count`` nonzero words (every fourth with the top bit set) at
    random flat positions of an all-zero array."""
    dt = unsigned(bits)
    flat = np.zeros(int(np.prod(shape)), dt)
    pos = rng.choice(flat.size, count, replace=False)
    vals = rng.integers(1, 2 ** (bits - 1), count, dtype=np.uint64)
    vals[::4] |= np.uint64(1) << np.uint64(bits - 1)
    flat[pos] = vals.astype(dt)
    return flat.reshape(shape)


def codec_inputs(bits):
    """name -> (words, budget)."""
    rng = np.random.default_rng(bits)
    top = random_words(rng, bits, (40,), 4)
    top[0] = unsigned(bits)(1 << (bits - 1)) | unsigned(bits)(5)
    return {
        "top_bit_at_0": (top, sparse_budget(40)),
        "over_budget": (random_words(rng, bits, (40,), 15),
                        sparse_budget(40)),
        "all_zero": (np.zeros(12, unsigned(bits)), sparse_budget(12)),
        "two_d": (random_words(rng, bits, (6, 4), 5), sparse_budget(24)),
    }


def gather_inputs(bits):
    """name -> words [NDEV, ROWS, WORDS], one slice per rank. ``sparse``:
    rank d has d + 1 nonzero words (the budget of 32 words is 8), rank 0's
    at flat index 0 with the top bit set; ``one_dense``: rank 2 has 12, so
    every group holding it ships dense (the 2x2 mesh's second row)."""
    rng = np.random.default_rng(100 + bits)
    shape = (ROWS, WORDS)
    sparse = np.stack([random_words(rng, bits, shape, d + 1)
                       for d in range(NDEV)])
    sparse[0, 0, 0] = unsigned(bits)(1 << (bits - 1))
    dense = np.stack([random_words(rng, bits, shape, 12 if d == 2 else 2)
                      for d in range(NDEV)])
    budget = sparse_budget(ROWS * WORDS, DENSE_THRESHOLD)
    assert 2 <= budget < 12         # the first row fits, the second not
    return {"sparse": sparse, "one_dense": dense,
            "all_zero": np.zeros((NDEV,) + shape, unsigned(bits))}


def write_inputs(path):
    arrays = {}
    for bits in BITS:
        for name, (words, budget) in codec_inputs(bits).items():
            arrays[f"codec/{bits}/{name}"] = words
            arrays[f"budget/{bits}/{name}"] = np.asarray(budget)
        for name, words in gather_inputs(bits).items():
            arrays[f"gather/{bits}/{name}"] = words
    np.savez(path, **arrays)


REF_CODE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import compat
from repro.core.exchange import (allreduce_or, exchange_expand,
                                 exchange_reduce_or, gather_words)
from repro.distributed.compression import (compress_words, decompress_words,
                                           wire_bytes, words_nnz)

inp = dict(np.load({inputs!r}))
devs = np.asarray(jax.devices()[:4])
MESHES = {{"1d": (Mesh(devs, ("data",)), "data"),
           "2x2": (Mesh(devs.reshape(2, 2), ("row", "col")), "col")}}
out = {{}}


def per_device(fn, mesh, words):
    axes = tuple(mesh.axis_names)

    def body(x):
        a, b = fn(x[0])
        return a[None], jnp.reshape(b, (1,))
    f = compat.shard_map(body, mesh=mesh, in_specs=(P(axes),),
                         out_specs=(P(axes), P(axes)), check_vma=False)
    a, b = jax.jit(f)(jnp.asarray(words))
    return np.asarray(a), np.asarray(b)


for bits in (32, 64):
    for key in [k for k in inp if k.startswith(f"codec/{{bits}}/")]:
        name = key.split("/")[-1]
        words = inp[key]
        budget = int(inp[f"budget/{{bits}}/{{name}}"])
        idx, pay, cnt = jax.jit(compress_words, static_argnums=1)(
            jnp.asarray(words), budget)
        assert pay.dtype == words.dtype
        out[f"{{key}}/idx"] = np.asarray(idx)
        out[f"{{key}}/payload"] = np.asarray(pay)
        out[f"{{key}}/count"] = np.asarray(cnt)
        out[f"{{key}}/nnz"] = np.asarray(words_nnz(jnp.asarray(words)))
        out[f"{{key}}/decompressed"] = np.asarray(
            decompress_words(idx, pay, words.size))
    for c in {counts!r}:
        for item in (4, 8):
            out[f"wire/{{bits}}/{{c}}/{{item}}"] = np.asarray(
                wire_bytes(jnp.int32(c), 32, 8, item))
    for key in [k for k in inp if k.startswith(f"gather/{{bits}}/")]:
        for mname, (mesh, axis) in MESHES.items():
            for compress in (False, True):
                a, b = per_device(
                    lambda x: gather_words(x, axis, compress), mesh, inp[key])
                out[f"{{key}}/{{mname}}/{{int(compress)}}/stacked"] = a
                out[f"{{key}}/{{mname}}/{{int(compress)}}/bytes"] = b
            if mname == "2x2":
                a, b = per_device(
                    lambda x: exchange_expand(x, axis, True), mesh, inp[key])
                out[f"{{key}}/expand"], out[f"{{key}}/expand_bytes"] = a, b
                a, b = per_device(
                    lambda x: exchange_reduce_or(x, axis, True), mesh,
                    inp[key])
                out[f"{{key}}/reduce"], out[f"{{key}}/reduce_bytes"] = a, b
            else:
                a, _ = per_device(
                    lambda x: (allreduce_or(x, ("data",)), jnp.int32(0)),
                    mesh, inp[key])
                out[f"{{key}}/allreduce_or"] = a
np.savez({out!r}, **out)
print("REF_EXCHANGE_OK")
"""


def exchange_rank(inputs_path):
    """Every rank: gather_words (dense and compressed) along the 1-D mesh
    and along the 2x2 mesh's "col" axis, the two 2-D exchanges and the OR
    all-reduce, on int32 and int64 words; the reductions; a gather on a
    mesh whose order is not the ranks'. Returns every rank's outputs (rank
    0's return value)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from repro_torch.core.exchange import (allreduce_or, all_gather,
                                           exchange_expand,
                                           exchange_reduce_or, gather_words,
                                           mesh_comm, pmax, pmin, psum)
    rank = dist.get_rank()
    inp = dict(np.load(inputs_path))
    comms = {"1d": mesh_comm(host_mesh(NDEV, "cpu")),
             "2x2": mesh_comm(init_device_mesh(
                 "cpu", (2, 2), mesh_dim_names=("row", "col")), "col")}
    out = {}
    for key in [k for k in inp if k.startswith("gather/")]:
        own = signed(inp[key][rank])
        for mname, comm in comms.items():
            for compress in (False, True):
                st, nbytes = gather_words(own, comm, compress)
                out[f"{key}/{mname}/{int(compress)}/stacked"] = st.numpy()
                out[f"{key}/{mname}/{int(compress)}/bytes"] = nbytes
        w, b = exchange_expand(own, comms["2x2"], True)
        out[f"{key}/expand"], out[f"{key}/expand_bytes"] = w.numpy(), b
        w, b = exchange_reduce_or(own, comms["2x2"], True)
        out[f"{key}/reduce"], out[f"{key}/reduce_bytes"] = w.numpy(), b
        out[f"{key}/allreduce_or"] = allreduce_or(own, comms["1d"]).numpy()
    x = torch.tensor([rank * 3 - 4, 7 - rank], dtype=torch.int32)
    for name, fn in (("psum", psum), ("pmin", pmin), ("pmax", pmax)):
        out[name] = fn(x, comms["1d"]).numpy()
    perm = [2, 0, 3, 1]
    shuffled = mesh_comm(DeviceMesh("cpu", perm, mesh_dim_names=("data",)))
    out["perm/index"] = shuffled.index
    out["perm/stacked"] = all_gather(torch.tensor([rank]), shuffled).numpy()
    ranks = [None] * NDEV
    dist.all_gather_object(ranks, out)
    return ranks


@pytest.fixture(scope="module")
def inputs_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("exchange") / "inputs.npz"
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
                                       out=str(path), counts=WIRE_COUNTS),
                       devices=NDEV, env_extra=X64_ENV), path,
           pool.submit(run_ranks, exchange_rank, NDEV, str(inputs_path),
                       device="cpu"))
    pool.shutdown()


@pytest.fixture(scope="module")
def ref(jobs):
    future, path, _ = jobs
    assert "REF_EXCHANGE_OK" in future.result()
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port(jobs):
    return jobs[2].result()


def same_words(got, want, what=""):
    """Port words (signed, a tensor or array) equal reference words
    (unsigned) as unsigned bits."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype.itemsize == want.dtype.itemsize, what
    np.testing.assert_array_equal(got.view(want.dtype), want,
                                  err_msg=str(what))


@pytest.mark.parametrize("name", CODEC_CASES)
@pytest.mark.parametrize("bits", BITS)
def test_codec_matches_reference(ref, bits, name):
    words, budget = codec_inputs(bits)[name]
    key = f"codec/{bits}/{name}"
    idx, payload, count = compress_words(signed(words), budget)
    assert idx.dtype == torch.int32 and count.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), ref[f"{key}/idx"])
    same_words(payload, ref[f"{key}/payload"], key)
    assert int(count) == int(ref[f"{key}/count"])
    assert int(words_nnz(signed(words))) == int(ref[f"{key}/nnz"])
    flat = decompress_words(idx, payload, words.size)
    same_words(flat, ref[f"{key}/decompressed"], key)
    if int(count) <= budget:       # the codec round-trips within budget
        same_words(flat, words.reshape(-1), key)


@pytest.mark.parametrize("bits", BITS)
def test_decompress_keeps_a_negative_word_at_index_0(bits):
    """Flat index 0 holds a word with the top bit set, a negative signed
    word: the pad slots (0, 0) must not clobber it, as they cannot in the
    reference's unsigned max-scatter."""
    words, budget = codec_inputs(bits)["top_bit_at_0"]
    t = signed(words)
    assert int(t[0]) < 0
    idx, payload, count = compress_words(t, budget)
    assert int(count) < budget and int(idx[0]) == 0
    assert torch.equal(decompress_words(idx, payload, words.size), t)


@pytest.mark.parametrize("bits", BITS)
def test_wire_bytes_matches_reference(ref, bits):
    for c in WIRE_COUNTS:
        for item in (4, 8):
            want = int(ref[f"wire/{bits}/{c}/{item}"])
            got = wire_bytes(torch.tensor(c, dtype=torch.int32), 32, 8, item)
            assert got.dtype == torch.int32 and int(got) == want, (c, item)
            assert wire_bytes(c, 32, 8, item) == want, (c, item)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("compress", [False, True], ids=["dense",
                                                         "compressed"])
@pytest.mark.parametrize("name", GATHER_CASES)
@pytest.mark.parametrize("bits", BITS)
def test_gather_words_matches_reference(ref, port, bits, name, compress,
                                        mesh):
    key = f"gather/{bits}/{name}/{mesh}/{int(compress)}"
    for rank in range(NDEV):
        same_words(port[rank][f"{key}/stacked"], ref[f"{key}/stacked"][rank],
                   (key, rank))
        nbytes = port[rank][f"{key}/bytes"]
        assert type(nbytes) is int and nbytes == int(ref[f"{key}/bytes"][rank])


@pytest.mark.parametrize("name", GATHER_CASES)
@pytest.mark.parametrize("bits", BITS)
def test_two_d_exchanges_match_reference(ref, port, bits, name):
    key = f"gather/{bits}/{name}"
    for rank in range(NDEV):
        for part in ("expand", "reduce"):
            same_words(port[rank][f"{key}/{part}"], ref[f"{key}/{part}"][rank],
                       (key, part, rank))
            assert (port[rank][f"{key}/{part}_bytes"]
                    == int(ref[f"{key}/{part}_bytes"][rank]))
        same_words(port[rank][f"{key}/allreduce_or"],
                   ref[f"{key}/allreduce_or"][rank], (key, rank))


def test_reductions_and_mesh_order(port):
    xs = np.array([[r * 3 - 4, 7 - r] for r in range(NDEV)], np.int32)
    for rank in range(NDEV):
        np.testing.assert_array_equal(port[rank]["psum"], xs.sum(axis=0))
        np.testing.assert_array_equal(port[rank]["pmin"], xs.min(axis=0))
        np.testing.assert_array_equal(port[rank]["pmax"], xs.max(axis=0))
        # a gather stacks in the mesh's order, [2, 0, 3, 1], not the ranks'
        assert port[rank]["perm/index"] == [2, 0, 3, 1].index(rank)
        np.testing.assert_array_equal(port[rank]["perm/stacked"].reshape(-1),
                                      [2, 0, 3, 1])


def test_host_mesh_raises_without_a_group():
    with pytest.raises(RuntimeError, match="run_ranks"):
        host_mesh(2, "cpu")


def test_run_ranks_on_the_gpu_needs_enough_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices, and 0"):
        run_ranks(exchange_rank, 2, "unused", device="cuda")
    with pytest.raises(RuntimeError, match="needs 1 CUDA devices, and 0"):
        run_ranks(exchange_rank, 1, "unused")
