"""The port's semiring layer and its two relax kernels' plain versions
against ``repro.traversal.semiring`` and ``repro.kernels.semiring_relax``.

Inputs are made from a seed with numpy and handed to both packages. The
Pallas kernel runs in interpret mode, as the JAX package's own tests run it.
Min-plus and OR are exact in any order, so tropical and boolean results
must be bit-equal; plus-times sums in another order than the reference's
scan, so it is held to ``rtol=1e-5``. The reference's functions are
jitted here: run eagerly, its associative scans compile op by op."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csr import from_edges as jfrom_edges
from repro.graph.generator import rmat_graph as jrmat
from repro.graph.generator import uniform_random_weighted_graph as juniform
from repro.kernels import semiring_relax_pallas
from repro.traversal import semiring as jsr
from repro_torch.core.csr import from_numpy_graph
from repro_torch.kernels.relax_fallback.ops import relax_fallback
from repro_torch.kernels.relax_fallback.ref import relax_fallback_ref
from repro_torch.kernels.semiring_relax.ops import semiring_relax
from repro_torch.kernels.semiring_relax.ref import semiring_relax_ref
from repro_torch.traversal import semiring as sr

j_segment_reduce = jax.jit(jsr.segment_reduce, static_argnums=2)
j_spmv = jax.jit(jsr.semiring_spmv, static_argnums=3)
j_fallback = jax.jit(jsr._relax_fallback, static_argnums=3)
j_tropical_relax = jax.jit(jsr.tropical_relax, static_argnums=(3, 4))

PAIRS = [(sr.TROPICAL, jsr.TROPICAL), (sr.PLUS_TIMES, jsr.PLUS_TIMES),
         (sr.BOOLEAN, jsr.BOOLEAN)]


def port_graph(jg):
    return from_numpy_graph(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                            np.asarray(jg.src_idx), "cpu")


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_bits_equal(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def lane_values(rng, shape, sr_port, masked=0.35):
    """Seeded lane values of the semiring's type: floats with ~35 % +inf
    (tropical), floats (plus-times), arbitrary bytes (boolean)."""
    if sr_port is sr.BOOLEAN:
        return rng.integers(0, 256, shape).astype(np.uint8)
    vals = rng.uniform(0, 8, shape).astype(np.float32)
    if sr_port is sr.TROPICAL:
        vals[rng.random(shape) < masked] = np.inf
    return vals


def check(got, want, sr_port):
    if sr_port is sr.PLUS_TIMES:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    else:
        assert_bits_equal(got, want)


@pytest.mark.parametrize("sr_port,sr_ref", PAIRS, ids=lambda s: s.name)
def test_segment_reduce_matches_reference(sr_port, sr_ref):
    """Rows with empty slices, and slots past row_ptr[-1] that belong to no
    row."""
    rng = np.random.default_rng(3)
    row_ptr = np.array([0, 3, 3, 4, 9, 9, 12], np.int32)
    vals = lane_values(rng, (15, 5), sr_port)
    got = sr.segment_reduce(t(vals), t(row_ptr), sr_port)
    check(got, j_segment_reduce(jnp.asarray(vals), jnp.asarray(row_ptr),
                                sr_ref), sr_port)


@pytest.mark.parametrize("sr_port,sr_ref", PAIRS, ids=lambda s: s.name)
@pytest.mark.parametrize("weighted", [False, True])
def test_semiring_spmv_matches_reference(sr_port, sr_ref, weighted):
    jg = jrmat(8, 8, seed=4)
    g = port_graph(jg)
    rng = np.random.default_rng(4)
    vals = lane_values(rng, (g.n + 5, 6), sr_port)   # nf > n
    w = None
    if weighted:
        w = (rng.integers(0, 2, g.m).astype(np.uint8) if sr_port is sr.BOOLEAN
             else rng.uniform(0, 1, g.m).astype(np.float32))
    got = sr.semiring_spmv(g, t(vals), None if w is None else t(w), sr_port)
    want = j_spmv(jg, jnp.asarray(vals),
                  None if w is None else jnp.asarray(w), sr_ref)
    check(got, want, sr_port)


def test_semiring_table():
    assert set(sr.SEMIRINGS) == set(jsr.SEMIRINGS)
    for name, s in sr.SEMIRINGS.items():
        assert (s.zero, s.one) == (jsr.SEMIRINGS[name].zero,
                                   jsr.SEMIRINGS[name].one)
        assert s.zeros((2, 3)).dtype == s.dtype


def relax_inputs(jwg, lanes, seed, nf=None, flat=False):
    rng = np.random.default_rng(seed)
    nf = jwg.n if nf is None else nf
    shape = (nf,) if flat else (nf, lanes)
    vals = rng.uniform(0, 8, shape).astype(np.float32)
    vals[rng.random(shape) < 0.35] = np.inf
    w = np.asarray(jwg.weights).copy()
    w[rng.random(w.shape) < 0.2] = np.inf                  # excluded edges
    return vals, w


@pytest.mark.parametrize("lanes", [1, 3, 8])
@pytest.mark.parametrize("max_pos", [1, 4, 8])
def test_semiring_relax_plain_matches_pallas(lanes, max_pos):
    jwg = juniform(300, 1500, seed=lanes * 10 + max_pos)
    vals, w = relax_inputs(jwg, lanes, lanes * 100 + max_pos)
    want = semiring_relax_pallas(jwg.row_ptr[:-1], jwg.deg, jwg.col_idx,
                                 jnp.asarray(w), jnp.asarray(vals),
                                 max_pos=max_pos, interpret=True)
    rp = t(np.asarray(jwg.row_ptr))
    got = semiring_relax_ref(rp[:-1], rp[1:] - rp[:-1],
                             t(np.asarray(jwg.col_idx)), t(w), t(vals),
                             max_pos)
    assert_bits_equal(got, want)
    # the wrapper the engine calls takes the plain version on the CPU
    assert_bits_equal(semiring_relax(rp, t(np.asarray(jwg.col_idx)), t(w),
                                     t(vals), max_pos), want)


def test_semiring_relax_flat_plane_matches_pallas():
    jwg = juniform(120, 500, seed=9)
    vals, w = relax_inputs(jwg, 1, 9, flat=True)
    want = semiring_relax_pallas(jwg.row_ptr[:-1], jwg.deg, jwg.col_idx,
                                 jnp.asarray(w), jnp.asarray(vals),
                                 max_pos=4, interpret=True)
    rp = t(np.asarray(jwg.row_ptr))
    got = semiring_relax_ref(rp[:-1], rp[1:] - rp[:-1],
                             t(np.asarray(jwg.col_idx)), t(w), t(vals), 4)
    assert got.shape == (jwg.n,)
    assert_bits_equal(got, want)


def test_semiring_relax_local_block_matches_pallas():
    """A local row block (the first half of the rows) against values of
    more rows than the block, neighbour ids global."""
    jwg = juniform(200, 900, seed=7)
    vals, w = relax_inputs(jwg, 3, 7, nf=jwg.n + 24)
    half = jwg.n // 2
    rp = np.asarray(jwg.row_ptr)[:half + 1]
    want = semiring_relax_pallas(jnp.asarray(rp[:-1]),
                                 jnp.asarray(rp[1:] - rp[:-1]), jwg.col_idx,
                                 jnp.asarray(w), jnp.asarray(vals),
                                 max_pos=4, interpret=True)
    got = semiring_relax_ref(t(rp[:-1]), t(rp[1:] - rp[:-1]),
                             t(np.asarray(jwg.col_idx)), t(w), t(vals), 4)
    assert got.shape == (half, 3)
    assert_bits_equal(got, want)


@pytest.mark.parametrize("weights", ["all_inf", "light", "fifth_inf"])
@pytest.mark.parametrize("max_pos", [4, 9])
def test_semiring_relax_wrapper_row_ptr_matches_pallas(weights, max_pos):
    """The wrapper the engine calls passes row_ptr to the kernel, which
    reads each row's start and degree from it; on the CPU the wrapper
    equals the Pallas kernel given starts and degrees: rows of degree 0,
    max_pos and deeper, neighbour ids over more rows than the block, and
    all-+inf, light (3 % finite) and 80 % finite weights."""
    rng = np.random.default_rng(max_pos)
    n, nf, lanes = 150, 190, 5
    deg = rng.integers(0, 3 * max_pos, n).astype(np.int32)
    deg[:3] = (0, max_pos, 2 * max_pos + 5)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    col = rng.integers(0, nf, row_ptr[-1]).astype(np.int32)
    w = rng.uniform(0, 1, col.size).astype(np.float32)
    finite = {"all_inf": 0.0, "light": 0.03, "fifth_inf": 0.8}[weights]
    w[rng.random(w.size) >= finite] = np.inf
    vals = rng.uniform(0, 8, (nf, lanes)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.35] = np.inf
    want = semiring_relax_pallas(jnp.asarray(row_ptr[:-1]), jnp.asarray(deg),
                                 jnp.asarray(col), jnp.asarray(w),
                                 jnp.asarray(vals), max_pos=max_pos,
                                 interpret=True)
    got = semiring_relax(t(row_ptr), t(col), t(w), t(vals), max_pos)
    assert got.shape == (n, lanes)
    assert_bits_equal(got, want)
    assert bool(torch.isinf(got).all()) == (weights == "all_inf")


@pytest.mark.parametrize("max_pos", [0, 2, 8])
def test_relax_fallback_plain_matches_reference(max_pos):
    """The residue fold against the reference's ``_relax_fallback``: with
    an all-inf base it is the fallback itself; with a seeded base, the
    reference's min of the two. nf > n, and rows of every depth."""
    jwg = juniform(150, 900, seed=max_pos)
    vals, w = relax_inputs(jwg, 5, max_pos + 50, nf=jwg.n + 9)
    fb = np.asarray(j_fallback(jwg.csr, jnp.asarray(w), jnp.asarray(vals),
                               max_pos))
    g = port_graph(jwg)
    rng = np.random.default_rng(max_pos)
    base = rng.uniform(0, 8, (g.n, 5)).astype(np.float32)
    base[rng.random(base.shape) < 0.5] = np.inf
    for b, want in ((np.full_like(base, np.inf), fb),
                    (base, np.minimum(base, fb))):
        for fold in (relax_fallback_ref, relax_fallback):
            bt = t(b.copy())
            out = fold(g.row_ptr, g.src_idx, g.col_idx, t(w), t(vals), bt,
                       max_pos)
            assert out is bt                              # in place
            assert_bits_equal(out, want)
    if max_pos:
        assert int(np.asarray(jwg.deg).max()) > max_pos   # the fold fires


@pytest.mark.parametrize("lanes,max_pos", [(1, 2), (4, 8)])
def test_tropical_relax_matches_reference(lanes, max_pos):
    """Both of the port's paths, bit-equal to the reference's edge-parallel
    path and to its kernel path (probe + cond-skipped fallback)."""
    jwg = juniform(90, 500, seed=5 + lanes)
    vals, w = relax_inputs(jwg, lanes, 5 + max_pos)
    want = j_tropical_relax(jwg.csr, jnp.asarray(w), jnp.asarray(vals),
                            max_pos, "xla")
    assert_bits_equal(
        torch.from_numpy(np.asarray(j_tropical_relax(
            jwg.csr, jnp.asarray(w), jnp.asarray(vals), max_pos, "pallas"))),
        want)
    g = port_graph(jwg)
    for impl in ("xla", "pallas"):
        assert_bits_equal(sr.tropical_relax(g, t(w), t(vals), max_pos, impl),
                          want)


def test_tropical_relax_edgeless_graph():
    jg = jfrom_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 6)
    g = port_graph(jg)
    vals = np.zeros((6, 3), np.float32)
    w = np.zeros(0, np.float32)
    want = jsr.tropical_relax(jg, jnp.asarray(w), jnp.asarray(vals), 8,
                              "xla")
    for impl in ("xla", "pallas"):
        assert_bits_equal(sr.tropical_relax(g, t(w), t(vals), 8, impl), want)
