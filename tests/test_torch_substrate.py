"""Graph substrate of the PyTorch port against the JAX package: generator,
CSR builders and bitmap ops. Every output is an integer array or a bitmap,
so the tolerance is exact equality throughout."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as jbitmap
from repro.core import csr as jcsr
from repro.core import ref as jref
from repro.graph import generator as jgen
from repro.graph import validate as jvalidate
from repro_torch.core import bitmap as tbitmap
from repro_torch.core import csr as tcsr
from repro_torch.core import ref as tref
from repro_torch.graph import generator as tgen
from repro_torch.graph import validate as tvalidate

CPU = "cpu"


def assert_graph_equal(jg, tg):
    assert tg.n == jg.n and tg.m == jg.m
    for name in ("row_ptr", "col_idx", "src_idx"):
        t = getattr(tg, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)


def words_u32(t):
    """The port's int32 words as the reference's uint32 words."""
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("scale,ef,seed", [(7, 16, 0), (8, 8, 1), (9, 4, 2),
                                           (10, 16, 3)])
def test_rmat_graph_matches(scale, ef, seed):
    assert_graph_equal(jgen.rmat_graph(scale, ef, seed=seed),
                       tgen.rmat_graph(scale, ef, seed=seed, device=CPU))


@pytest.mark.parametrize("n,m,seed", [(10, 10, 0), (37, 80, 1), (400, 1200, 3),
                                      (61, 15, 4)])
def test_uniform_random_graph_matches(n, m, seed):
    assert_graph_equal(jgen.uniform_random_graph(n, m, seed=seed),
                       tgen.uniform_random_graph(n, m, seed=seed, device=CPU))


@pytest.mark.parametrize("num,seed,require_edges", [(4, 1, True),
                                                    (64, 7, True),
                                                    (16, 2, False)])
def test_sample_roots_matches(num, seed, require_edges):
    jg = jgen.uniform_random_graph(300, 200, seed=5)
    tg = tgen.uniform_random_graph(300, 200, seed=5, device=CPU)
    np.testing.assert_array_equal(
        tgen.sample_roots(tg, num, seed=seed, require_edges=require_edges),
        jgen.sample_roots(jg, num, seed=seed, require_edges=require_edges))


def test_from_numpy_graph_carries_the_reference_graph():
    jg = jgen.rmat_graph(9, 8, seed=4)
    rp, ci = jcsr.to_numpy_adj(jg)
    tg = tcsr.from_numpy_graph(rp, ci, np.asarray(jg.src_idx), CPU)
    assert_graph_equal(jg, tg)
    trp, tci = tcsr.to_numpy_adj(tg)
    np.testing.assert_array_equal(trp, rp)
    np.testing.assert_array_equal(tci, ci)
    np.testing.assert_array_equal(tg.deg.numpy(), np.asarray(jg.deg))


@pytest.mark.parametrize("symmetrize,drop_self_loops,dedup", [
    (True, True, False), (False, False, False), (True, False, True),
    (False, True, True)])
def test_from_edges_options_match(symmetrize, drop_self_loops, dedup):
    rng = np.random.default_rng(11)
    src = rng.integers(0, 50, size=400)
    dst = rng.integers(0, 50, size=400)
    kw = dict(symmetrize=symmetrize, drop_self_loops=drop_self_loops,
              dedup=dedup)
    assert_graph_equal(jcsr.from_edges(src, dst, 50, **kw),
                       tcsr.from_edges(src, dst, 50, device=CPU, **kw))


def test_from_edges_overflow_guard():
    big = np.broadcast_to(np.int8(0), (2 ** 31 + 8,))
    with pytest.raises(ValueError, match="overflow"):
        tcsr.from_edges(big, big, 4, symmetrize=False, drop_self_loops=False,
                        device=CPU)


def test_relabel_matches():
    jg = jgen.rmat_graph(8, 8, seed=6)
    tg = tgen.rmat_graph(8, 8, seed=6, device=CPU)
    perm = np.random.default_rng(6).permutation(jg.n)
    assert_graph_equal(jcsr.relabel(jg, perm), tcsr.relabel(tg, perm))


@pytest.mark.parametrize("k_max", [1, 4, 16])
def test_ell_pad_matches(k_max):
    jg = jgen.uniform_random_graph(200, 900, seed=k_max)
    tg = tgen.uniform_random_graph(200, 900, seed=k_max, device=CPU)
    jn, jv = jcsr.ell_pad(jg, k_max)
    tn, tv = tcsr.ell_pad(tg, k_max)
    assert tn.dtype == torch.int32 and tv.dtype == torch.bool
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _mask(n, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.3
    mask[31::32] = True  # bit 31 of every word: the int32 sign bit
    return mask


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 1000])
def test_pack_unpack_match(n):
    mask = _mask(n, n)
    jw = jbitmap.pack(jnp.asarray(mask))
    tw = tbitmap.pack(torch.from_numpy(mask))
    assert tw.dtype == torch.int32
    assert tw.numel() == tbitmap.num_words(n) == jbitmap.num_words(n)
    np.testing.assert_array_equal(words_u32(tw), np.asarray(jw))
    np.testing.assert_array_equal(tbitmap.unpack(tw, n).numpy(), mask)
    np.testing.assert_array_equal(tbitmap.unpack(tw, n).numpy(),
                                  np.asarray(jbitmap.unpack(jw, n)))


@pytest.mark.parametrize("n", [33, 100, 1000])
def test_test_and_popcount_match(n):
    mask = _mask(n, n + 1)
    jw = jbitmap.pack(jnp.asarray(mask))
    tw = tbitmap.pack(torch.from_numpy(mask))
    nbits = tbitmap.num_words(n) * 32
    ids = np.concatenate([np.arange(-3, nbits + 5), [2 ** 31 - 1, -2 ** 31]])
    ids = ids.astype(np.int32)
    got = tbitmap.test(tw, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jbitmap.test(jw, ids)))
    assert not got[:3].any() and not got[-7:].any()  # out of range -> False
    pc = tbitmap.popcount_words(tw)
    assert pc.dtype == torch.int32
    assert int(pc) == int(jbitmap.popcount_words(jw)) == int(mask.sum())


@pytest.mark.parametrize("with_valid", [False, True])
def test_set_bits_matches(with_valid):
    n = 70
    mask = _mask(n, 3)
    rng = np.random.default_rng(4)
    idx = rng.integers(-5, 100, size=40).astype(np.int32)  # some out of range
    valid = rng.random(40) < 0.5 if with_valid else None
    jw = jbitmap.set_bits(jbitmap.pack(jnp.asarray(mask)), jnp.asarray(idx),
                          None if valid is None else jnp.asarray(valid))
    tw = tbitmap.set_bits(tbitmap.pack(torch.from_numpy(mask)),
                          torch.from_numpy(idx),
                          None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(words_u32(tw), np.asarray(jw))


def test_numpy_copies_match_the_reference():
    """The port keeps its own copies of the numpy oracle and validator."""
    g = jgen.rmat_graph(8, 8, seed=2)
    rp, ci = jcsr.to_numpy_adj(g)
    root = int(jgen.sample_roots(g, 1, seed=3)[0])
    p1, d1 = jref.bfs_reference(rp, ci, root)
    p2, d2 = tref.bfs_reference(rp, ci, root)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(tref.bfs_queue(rp, ci, root),
                                  jref.bfs_queue(rp, ci, root))
    assert (tvalidate.validate_bfs_tree(rp, ci, p2, root)
            == jvalidate.validate_bfs_tree(rp, ci, p1, root))
    bad = p2.copy()
    bad[bad == root] = -1
    with pytest.raises(tvalidate.ValidationError):
        tvalidate.validate_bfs_tree(rp, ci, bad, root)
