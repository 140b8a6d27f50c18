"""The port's logical-axis resolver (``distributed/sharding.py``) and meshes
(``launch/mesh.py``) against the reference's.

On both production meshes, 16x16 ("data", "model") and 2x16x16 ("pod",
"data", "model"), ``resolve_spec`` must give the reference's assignment on
a ``jax.sharding.AbstractMesh`` for every leaf of every cell's
``step_arg_specs``, and the bytes one device holds must equal the sum of
the reference's shard shapes. The reference's own resolver tests
(``tests/test_substrate.py``) are mirrored. The meshes are ``DeviceMesh``es
over a fake process group, started in a child process so that no test
worker keeps a default group.
"""
import textwrap

import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from conftest import run_in_subprocess
from repro.configs import base as jbase
from repro.distributed.sharding import resolve_spec as jresolve
from repro_torch.configs import base as tbase
from repro_torch.distributed.sharding import (batch_axes, resolve_spec,
                                              tree_shardings)
from test_torch_shapes import CELLS, flat_leaves

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def axis_map(mesh_id):
    shape, names = MESHES[mesh_id]
    return dict(zip(names, shape))


@pytest.mark.parametrize("arch_id,shape_id", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_resolver_matches_reference(arch_id, shape_id):
    arch = tbase.get_arch(arch_id)
    args, specs = tbase.step_arg_specs(arch, arch.shape(shape_id))
    jarch = jbase.get_arch(arch_id)
    jargs, jspecs = jbase.step_arg_specs(jarch, jarch.shape(shape_id))
    ref = {p: (x, s) for p, x, s in flat_leaves(jargs, jspecs)}
    for mesh_id, (shape, names) in MESHES.items():
        amesh = AbstractMesh(shape, names)
        shardings = tree_shardings(args, specs, axis_map(mesh_id))
        want_bytes = 0
        for path, t, spec in flat_leaves(args, specs):
            x, jspec = ref[path]
            want = jresolve(tuple(x.shape), jspec, amesh)
            got = shardings[path]
            assert got.spec == tuple(want), (mesh_id, path)
            assert resolve_spec(tuple(t.shape), spec,
                                axis_map(mesh_id)) == tuple(want)
            local = NamedSharding(amesh, want).shard_shape(tuple(x.shape))
            assert got.local_shape == tuple(local), (mesh_id, path)
            want_bytes += int(np.prod(local)) * np.dtype(x.dtype).itemsize
        assert sum(s.local_bytes for s in shardings.values()) == want_bytes


def test_resolver_divisibility_fallback():
    mesh = {"data": 16, "model": 16}
    # 40 kv heads don't divide 16: the dim stays whole
    assert resolve_spec((64, 40, 128), (None, "kv_heads", "kv_seq"),
                        mesh) == (None, None, "model")
    # vocab divisible: sharded on model
    assert resolve_spec((128256, 512), ("vocab", "embed"),
                        mesh) == ("model", "data")


def test_resolver_no_double_axis_use():
    # both want 'model'; the second dim falls back
    assert resolve_spec((16, 16), ("mlp", "heads"),
                        {"data": 4, "model": 4}) == ("model",)


def test_resolver_pod_axis():
    mesh = {"pod": 2, "data": 16, "model": 16}
    assert resolve_spec((256, 4096), ("batch", None), mesh)[0] \
        == ("pod", "data")
    assert batch_axes(mesh) == ("pod", "data")
    assert batch_axes({"data": 16, "model": 16}) == ("data",)


@pytest.mark.parametrize("shape,logical", [
    ((32, 40, 128), (None, "kv", "heads")),
    ((8, 1024), ("batch", "embed")),
    ((16384, 53248), ("embed", "mlp")),
    ((3, 96, 96), (None, "mlp", "mlp")),
    ((7,), ("nodes",)),
    ((), None),
])
def test_resolver_leaf_cases(shape, logical):
    for mesh_id, (mshape, names) in MESHES.items():
        want = jresolve(shape, logical, AbstractMesh(mshape, names))
        assert resolve_spec(shape, logical, axis_map(mesh_id)) \
            == tuple(want if want is not None else P())


def test_meshes_over_fake_group():
    """``make_production_mesh`` and ``host_device_mesh`` over fake groups:
    the reference's shapes and axis names; ``tree_shardings`` on the
    ``DeviceMesh`` equals it on the axis-size mapping, with a DTensor
    placement per mesh axis. Importing the mesh module starts no group."""
    out = run_in_subprocess(textwrap.dedent("""
        import torch.distributed as dist
        from torch.distributed.tensor import Shard
        from repro_torch.launch import mesh as M
        from repro_torch.configs.base import get_arch, step_arg_specs
        from repro_torch.distributed.sharding import tree_shardings, axis_sizes
        assert not dist.is_initialized()
        arch = get_arch("qwen1.5-32b")
        args, specs = step_arg_specs(arch, arch.shape("decode_32k"))
        for mp, world in ((False, 256), (True, 512)):
            with M.fake_process_group(world):
                mesh = M.make_production_mesh(multi_pod=mp)
                sizes = axis_sizes(mesh)
                got = tree_shardings(args, specs, mesh)
                assert got == tree_shardings(args, specs, sizes)
                emb = got["0.embed"]
                assert emb.placements[-1] == Shard(0)
                assert all(p == Shard(1) for p in emb.placements[:-1])
                k = got["1.cache_k"]   # 40 kv heads: the model axis takes seq
                assert k.spec[2] == "model" and len(k.spec) == 3
                print(tuple(mesh.shape), mesh.mesh_dim_names)
            assert not dist.is_initialized()
        with M.fake_process_group(8):
            m = M.host_device_mesh(2)
            print(tuple(m.shape), m.mesh_dim_names)
            m = M.make_mesh((4, 2), ("a", "b"))
            print(m["b"].mesh.tolist())
    """)).splitlines()
    assert out == ["(16, 16) ('data', 'model')",
                   "(2, 16, 16) ('pod', 'data', 'model')",
                   "(4, 2) ('data', 'model')",
                   "[0, 1]"]
