"""The port's packed lane-word primitives against ``repro.core.packed``.

Lane words are int32 bit patterns in the port and uint32 in the reference;
they are compared as uint32. The inputs are made with numpy from a seed and
handed to both packages. Outputs are integer arrays, so the tolerance is
exact equality. On the CPU the port's steps take the kernels' plain
versions; the reference's probe runs through its XLA formulation and, in
one leg, through the Pallas kernel in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packed as jpacked
from repro.graph.generator import rmat_graph as jrmat
from repro.graph.generator import uniform_random_graph as juniform
from repro.kernels import msbfs_probe_pallas
from repro_torch.core import packed
from repro_torch.core.csr import from_numpy_graph
from repro_torch.kernels.msbfs_probe.ops import msbfs_probe
from repro_torch.kernels.msbfs_probe.ref import msbfs_probe_ref


# jitted once per shape: eagerly the reference's lax.cond branches compile
# again on every call
j_bottomup = jax.jit(jpacked.bottomup_packed_step, static_argnums=(4, 5))
j_topdown = jax.jit(jpacked.topdown_packed_step)
j_dispatch = jax.jit(jpacked.dispatch_packed_step, static_argnums=(5, 6, 7))
j_segment_or = jax.jit(jpacked.segment_or)


def port_graph(jg):
    return from_numpy_graph(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                            np.asarray(jg.src_idx), "cpu")


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def lane_words(n, w, seed):
    """Seeded uint32[n, w] (frontier, visited) with the frontier inside
    visited, as in a traversal; sparse enough to leave a residue."""
    rng = np.random.default_rng(seed)

    def words():
        return rng.integers(0, 2 ** 32, (n, w), dtype=np.uint32)
    fro = words() & words() & words()
    return fro, fro | (words() & words())


@pytest.fixture(scope="module")
def graphs():
    return {"rmat": jrmat(9, 8, seed=1), "uniform": juniform(300, 900, seed=2)}


@pytest.mark.parametrize("r", [1, 31, 32, 33, 64])
def test_pack_unpack_roundtrip(r):
    rng = np.random.default_rng(r)
    mask = rng.random((17, r)) < 0.5
    mask[3, r - 1] = True  # lane 31 sets the sign bit of a port word
    words = packed.pack_lanes(torch.from_numpy(mask))
    assert words.dtype == torch.int32
    assert words.shape == (17, packed.num_lane_words(r))
    np.testing.assert_array_equal(u32(words),
                                  np.asarray(jpacked.pack_lanes(
                                      jnp.asarray(mask))))
    np.testing.assert_array_equal(packed.unpack_lanes(words, r).numpy(),
                                  mask)
    np.testing.assert_array_equal(packed.pack_lanes_np(mask[3]),
                                  words[3].numpy())


def test_pack_lanes_top_bit():
    mask = torch.zeros((3, 32), dtype=torch.bool)
    mask[1, 31] = True
    np.testing.assert_array_equal(u32(packed.pack_lanes(mask)),
                                  np.array([[0], [1 << 31], [0]], np.uint32))


def test_depth_slice_words():
    rng = np.random.default_rng(1)
    depth = rng.integers(-1, 5, size=(29, 35)).astype(np.int32)
    for lo, hi in ((0, 2), (1, 1), (0, np.iinfo(np.int32).max)):
        np.testing.assert_array_equal(
            u32(packed.depth_slice_words(torch.from_numpy(depth), hi, lo)),
            np.asarray(jpacked.depth_slice_words(jnp.asarray(depth), hi,
                                                 lo)))


def test_segment_or_with_empty_trailing_and_padded_rows():
    # rows: [], [a, b], [], [c], [], []; slots 4 and 5 lie past row_ptr[-1]
    # (distributed edge-slab padding) and must reach no row
    row_ptr = np.array([0, 0, 2, 2, 3, 3, 3], np.int32)
    vals = np.random.default_rng(0).integers(0, 2 ** 32, (6, 3),
                                             dtype=np.uint32)
    vals[0, 0] |= np.uint32(1 << 31)
    got = packed.segment_or(i32(vals), torch.from_numpy(row_ptr))
    np.testing.assert_array_equal(
        u32(got), np.asarray(j_segment_or(jnp.asarray(vals),
                                          jnp.asarray(row_ptr))))


@pytest.mark.parametrize("w,extra_rows,max_pos", [(1, 0, 8), (2, 0, 8),
                                                  (3, 0, 8), (2, 40, 8),
                                                  (2, 0, 1)])
def test_msbfs_probe_plain_matches_pallas(graphs, w, extra_rows, max_pos):
    """Raw acc, not only acc & need: both retire per word plane. With
    extra_rows the frontier has more rows than the graph (nf > n)."""
    jg = graphs["rmat"]
    g = port_graph(jg)
    fro, vis = lane_words(jg.n + extra_rows, w, w + extra_rows)
    need = ~vis[:jg.n]
    want = msbfs_probe_pallas(jg.row_ptr[:-1], jg.deg, jnp.asarray(need),
                              jg.col_idx, jnp.asarray(fro), max_pos=max_pos,
                              interpret=True)
    got = msbfs_probe_ref(g.row_ptr[:-1], g.deg, i32(need), g.col_idx,
                          i32(fro), max_pos)
    np.testing.assert_array_equal(u32(got), np.asarray(want))
    np.testing.assert_array_equal(
        u32(msbfs_probe(g.row_ptr, g.col_idx, i32(fro), i32(need), max_pos)),
        np.asarray(want))
    # the reference's XLA probe retires per vertex, so only acc & need agree
    xla = packed.probe_xla(g, i32(fro), i32(need), max_pos)
    np.testing.assert_array_equal(u32(xla) & need, np.asarray(want) & need)


@pytest.mark.parametrize("key,w,max_pos", [("rmat", 2, 8), ("uniform", 1, 1)])
def test_packed_steps_match_reference(graphs, key, w, max_pos):
    jg = graphs[key]
    g = port_graph(jg)
    fro, vis = lane_words(jg.n, w, 7 * w + max_pos)
    sel = np.array([0xF0F0FFFF, 0xFFFFFFFF][:w], np.uint32)
    jf, jv, js = jnp.asarray(fro), jnp.asarray(vis), jnp.asarray(sel)
    want_bu = np.asarray(j_bottomup(jg, jf, jv, js, max_pos, "xla"))
    got_bu = packed.bottomup_packed_step(g, i32(fro), i32(vis), i32(sel),
                                         max_pos)
    np.testing.assert_array_equal(u32(got_bu), want_bu)
    want_td = np.asarray(j_topdown(jg, jf, jv, js))
    got_td = packed.topdown_packed_step(g, i32(fro), i32(vis), i32(sel))
    np.testing.assert_array_equal(u32(got_td), want_td)
    # the per-layer dispatch: both directions, one direction, none
    for td, bu in ((sel, ~sel), (sel * 0, sel), (sel * 0, sel * 0)):
        want = j_dispatch(jg, jf, jv, jnp.asarray(td), jnp.asarray(bu),
                          "hybrid", max_pos, "xla")
        got = packed.dispatch_packed_step(g, i32(fro), i32(vis),
                                          td.view(np.int32),
                                          bu.view(np.int32), "hybrid",
                                          max_pos)
        np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_bottomup_step_matches_pallas_leg(graphs):
    """The reference's packed bottom-up through its Pallas probe."""
    jg = graphs["rmat"]
    fro, vis = lane_words(jg.n, 2, 3)
    sel = np.array([0xFFFFFFFF, 0x0000FFFF], np.uint32)
    want = j_bottomup(jg, jnp.asarray(fro), jnp.asarray(vis),
                      jnp.asarray(sel), 8, "pallas")
    got = packed.bottomup_packed_step(port_graph(jg), i32(fro), i32(vis),
                                      i32(sel), 8)
    np.testing.assert_array_equal(u32(got), np.asarray(want))


def test_lane_counters_match_reference(graphs):
    jg = graphs["rmat"]
    rng = np.random.default_rng(4)
    vis = rng.random((jg.n, 40)) < 0.5
    fro = vis & (rng.random((jg.n, 40)) < 0.3)
    want = jpacked.lane_counters(jg, jnp.asarray(fro), jnp.asarray(vis))
    got = packed.lane_counters(port_graph(jg), torch.from_numpy(fro),
                               torch.from_numpy(vis))
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_claims_match_reference(seed):
    rng = np.random.default_rng(seed)
    cap, lanes = 20, 12
    queue = rng.integers(0, 500, cap).astype(np.int32)
    lane_qidx = np.where(rng.random(lanes) < 0.5, cap,
                         rng.integers(0, cap, lanes)).astype(np.int32)
    for next_root, queued in ((0, 0), (3, 9), (15, 20), (20, 20)):
        want = jpacked.queue_claims(jnp.asarray(lane_qidx),
                                    jnp.int32(next_root), jnp.int32(queued),
                                    jnp.asarray(queue))
        got = packed.queue_claims(lane_qidx, next_root, queued, queue)
        claim = np.asarray(want[0])
        np.testing.assert_array_equal(got[0], claim)
        for a, b in zip(got[1:], want[1:]):  # meaningful where claimed
            np.testing.assert_array_equal(a[claim], np.asarray(b)[claim])


def test_adaptive_lane_pool_matches_reference():
    for pending in (1, 5, 33, 64, 100, 300):
        for n, m in ((1000, 1500), (1000, 6000), (1 << 20, 1 << 25),
                     (1 << 24, 1 << 26)):
            assert (packed.adaptive_lane_pool(pending, n, m)
                    == jpacked.adaptive_lane_pool(pending, n, m))
    with pytest.raises(ValueError, match="non-empty"):
        packed.adaptive_lane_pool(4, 0, 0)
