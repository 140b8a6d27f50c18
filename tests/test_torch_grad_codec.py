"""The port's gradient codec against the JAX package's
(``repro.distributed.compression``'s gradient half).

``init_error_state``, ``compress_tree`` and ``decompress_tree`` get the
same seeded float32 trees as the reference's, values at exact .5
quantisation steps included (round-half-even on both sides): the int8
payloads, float32 scales, error state and decompressed trees must be equal
bit for bit, over three steps of error feedback. ``psum_compressed`` runs
on four gloo ranks (``distributed/ranks.py::run_ranks``, each rank its own
tree) and must equal, bit for bit, the same formula reckoned in numpy from
the four ranks' trees; the reference's ``psum_compressed`` under its
``shard_map`` on four forced host devices, in a child process, must give
the same bits.
"""
import json
import threading

import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.distributed.compression import (compress_tree,
                                                 decompress_tree,
                                                 init_error_state,
                                                 psum_compressed)
from repro_torch.distributed.ranks import run_ranks

NDEV = 4
SHAPES = {"w": (6, 5), "b": (7,), "layers": {"0": (3, 4), "1": (2, 2, 3)}}


def _tree(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _tree(v, fn) for k, v in shapes.items()}
    return fn(shapes)


def numpy_tree(seed: int):
    """Seeded float32 leaves; in "w" a row of exact .5 steps of its scale
    (127 at the largest magnitude, so k + .5 quantises to the even
    neighbour)."""
    rng = np.random.default_rng(seed)
    tree = _tree(SHAPES, lambda s: rng.standard_normal(s).astype(np.float32))
    w = tree["w"]
    w[0] = np.float32(127.0)
    w[1] = np.asarray([0.5, 1.5, 2.5, -0.5, -3.5], np.float32)
    return tree


def torch_tree(tree):
    return _tree(tree, lambda a: torch.from_numpy(np.array(a)))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def np_psum(trees, errs):
    """``psum_compressed``'s formula in numpy over the ranks' trees and
    error states: {leaf path: (the sum, [each rank's new error])}."""
    got = {}
    for name in (p for p, _ in _leaves(trees[0])):
        xs = [dict(_leaves(t))[name] + dict(_leaves(e))[name]
              for t, e in zip(trees, errs)]
        scale = max(np.maximum(np.max(np.abs(x)), np.float32(1e-12))
                    / np.float32(127.0) for x in xs)
        qs = [np.clip(np.round(x / scale), -127, 127).astype(np.int8)
              for x in xs]
        total = np.sum([q.astype(np.int32) for q in qs], axis=0)
        got[name] = (total.astype(np.float32) * scale,
                     [x - q.astype(np.float32) * scale
                      for x, q in zip(xs, qs)])
    return got


def psum_rank(seeds):
    """A gloo rank: two ``psum_compressed`` steps of its own tree, the
    error state carried; returns (sums, errors) per step as lists."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    r = dist.get_rank()
    tree = torch_tree(numpy_tree(seeds[r]))
    err = init_error_state(tree)
    steps = []
    for _ in range(2):
        total, err = psum_compressed(tree, err)
        steps.append(({p: v.numpy().tolist() for p, v in _leaves(total)},
                      {p: v.numpy().tolist() for p, v in _leaves(err)}))
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, steps)
    return out


REF_PSUM = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import compat
from repro.distributed.compression import init_error_state, psum_compressed
import test_torch_grad_codec as t

mesh = jax.make_mesh((4,), ("data",))
trees = [t.numpy_tree(s) for s in t.SEEDS]
stack = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)

def body(g):
    g = jax.tree.map(lambda x: x[0], g)
    e = init_error_state(g)
    steps = []
    for _ in range(2):
        total, e = psum_compressed(g, e, "data")
        steps.append((total, e))
    return jax.tree.map(lambda x: x[None], steps)

spec = jax.tree.map(lambda _: P("data"), stack)
out = compat.shard_map(body, mesh=mesh, in_specs=(spec,), out_specs=P("data"),
                       check_vma=False)(stack)
out = jax.device_get(out)
print(json.dumps([[[{p: np.asarray(v)[r].tolist() for p, v in t._leaves(h)}
                    for h in s] for s in out] for r in range(4)]))
"""
SEEDS = (11, 12, 13, 14)


@pytest.fixture(scope="module")
def launches():
    """The gloo ranks and the reference's child, started together."""
    out = {}

    def ref():
        try:
            out["ref"] = run_in_subprocess(
                "import sys; sys.path.insert(0, 'tests')\n" + REF_PSUM,
                devices=NDEV)
        except Exception as e:  # reported by the test that reads it
            out["ref"] = e

    th = threading.Thread(target=ref)
    th.start()
    out["port"] = run_ranks(psum_rank, NDEV, SEEDS, device="cpu")
    th.join()
    return out


@pytest.fixture(scope="module")
def refc():
    pytest.importorskip("jax")
    from repro.distributed import compression
    return compression


def test_compress_tree_bit_equal(refc):
    """Three steps of error feedback: payloads, scales, error state and
    the decompressed tree equal the reference's bit for bit."""
    import jax
    trees = [numpy_tree(s) for s in (1, 2, 3)]
    err_j = refc.init_error_state(trees[0])
    err = init_error_state(torch_tree(trees[0]))
    for tree in trees:
        q_j, err_j = refc.compress_tree(tree, err_j)
        q, err = compress_tree(torch_tree(tree), err)
        d_j, d = refc.decompress_tree(q_j), decompress_tree(q)
        q_j, err_j_np = jax.device_get(q_j), jax.device_get(err_j)
        flat_q = dict(_pairs(q))
        for path, (qq_j, s_j) in _pairs(q_j):
            qq, s = flat_q[path]
            assert qq.dtype == torch.int8 and s.dtype == torch.float32
            np.testing.assert_array_equal(qq.numpy(), np.asarray(qq_j))
            assert s.numpy().tobytes() == np.asarray(s_j).tobytes(), path
        for got, want in ((err, err_j_np), (d, jax.device_get(d_j))):
            want = dict(_leaves(want))
            assert set(want) == set(dict(_leaves(got)))
            for p, a in _leaves(got):
                assert a.numpy().tobytes() == np.asarray(want[p]).tobytes(), p


def _pairs(qtree, prefix=""):
    """(path, (q, scale)) of a quantised tree."""
    if isinstance(qtree, dict):
        for k, v in qtree.items():
            yield from _pairs(v, f"{prefix}/{k}")
    else:
        yield prefix, qtree


def test_half_steps_round_to_even():
    """A .5 step quantises to the even neighbour, as jnp.round does."""
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -3.5])
    qtree, _ = compress_tree({"x": x}, init_error_state({"x": x}))
    q, scale = qtree["x"]
    assert float(scale) == 1.0
    assert q.tolist() == [127, 0, 2, 2, 0, -4]


def test_psum_compressed_matches_numpy(launches):
    """Two steps on four gloo ranks: every rank's sums and error state
    equal the numpy formula over the four trees, bit for bit."""
    port = launches["port"]
    trees = [numpy_tree(s) for s in SEEDS]
    errs = [_tree(SHAPES, lambda s: np.zeros(s, np.float32))] * NDEV
    for step in range(2):
        want = np_psum(trees, errs)
        for r in range(NDEV):
            sums, err = port[r][step]
            for name, (total, new_errs) in want.items():
                assert np.asarray(sums[name], np.float32).tobytes() \
                    == total.tobytes(), (step, r, name)
                assert np.asarray(err[name], np.float32).tobytes() \
                    == new_errs[r].tobytes(), (step, r, name)
        errs = [_tree_from(SHAPES, {n: want[n][1][r] for n in want})
                for r in range(NDEV)]


def _tree_from(shapes, flat, prefix=""):
    if isinstance(shapes, dict):
        return {k: _tree_from(v, flat, f"{prefix}/{k}")
                for k, v in shapes.items()}
    return flat[prefix]


def test_psum_compressed_matches_reference_shard_map(launches):
    """The reference's ``psum_compressed`` under ``shard_map`` on four
    forced host devices gives the port's bits on every rank."""
    ref = launches["ref"]
    if isinstance(ref, Exception):
        raise ref
    ref = json.loads(ref.strip().splitlines()[-1])
    for r in range(NDEV):
        for step in range(2):
            for half in range(2):
                got, want = launches["port"][r][step][half], ref[r][step][half]
                for name in want:
                    assert np.asarray(got[name], np.float32).tobytes() \
                        == np.asarray(want[name], np.float32).tobytes(), (
                            r, step, half, name)
