"""The port's multi-source BFS engines against ``repro.core.msbfs``.

The same graph (carried over with ``from_numpy_graph``), roots and
arguments go through both packages; all eight ``MSBFSResult`` fields must be
equal, bit for bit, and so must the stepping API's states and read-outs,
from a fresh engine and from a reference state carried across mid-sweep
(``pipeline_state_from_numpy``). On the CPU the port's steps take the
kernels' plain versions. The reference's results are built once per module.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import msbfs as jms
from repro.graph import graph500 as jgraph500
from repro.graph.generator import rmat_graph as jrmat
from repro.graph.generator import sample_roots
from repro_torch.core import msbfs as ms
from repro_torch.core.csr import from_edges, from_numpy_graph, to_numpy_adj
from repro_torch.core.hybrid import MAX_TRACE, bfs
from repro_torch.core.packed import adaptive_lane_pool
from repro_torch.core.ref import bfs_reference
from repro_torch.graph.graph500 import run_graph500
from repro_torch.graph.validate import validate_bfs_tree
from repro_torch.obs import SweepRecorder

FIELDS = ms.MSBFSResult._fields


def port_graph(jg):
    return from_numpy_graph(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                            np.asarray(jg.src_idx), "cpu")


def assert_results_equal(got, want, what=""):
    for name in FIELDS:
        t = getattr(got, name)
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(want,
                                                                    name)),
                                      err_msg=f"{name} {what}")


def assert_results_same(a, b, what=""):
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(b, name)), \
            f"{name} {what}"


@pytest.fixture(scope="module")
def case():
    jg = jrmat(9, 16, seed=0)
    return SimpleNamespace(jg=jg, g=port_graph(jg),
                           roots=sample_roots(jg, 40, seed=1), cache={})


def reference(case, key, fn):
    if key not in case.cache:
        case.cache[key] = fn()
    return case.cache[key]


def jax_msbfs(case, mode):
    return reference(case, ("msbfs", mode), lambda: jms.msbfs(
        case.jg, jnp.asarray(case.roots), mode))


@pytest.mark.parametrize("mode", ["hybrid", "topdown", "bottomup"])
def test_msbfs_matches_reference(case, mode):
    want = jax_msbfs(case, mode)
    got = ms.msbfs(case.g, case.roots, mode)
    assert_results_equal(got, want, mode)
    for band in ((2, 0), (1, 1), (None, 0)):
        np.testing.assert_array_equal(
            got.reached_words(*band).numpy().view(np.uint32),
            np.asarray(want.reached_words(*band)))


def test_pipelined_beyond_lane_pool_matches_reference(case):
    """40 roots through 16 lanes: refills on the way."""
    want = reference(case, ("pipelined", 16), lambda: jms.msbfs_pipelined(
        case.jg, jnp.asarray(case.roots), "hybrid", lanes=16))
    assert_results_equal(ms.msbfs_pipelined(case.g, case.roots, "hybrid",
                                            lanes=16), want)


def test_pipelined_within_lane_pool_equals_single_batch(case):
    """Fewer roots than lanes: the pool shrinks to two words and the sweep
    gives the single-batch results (the reference's own engines agree)."""
    got = ms.msbfs_pipelined(case.g, case.roots, "hybrid", lanes=64)
    assert_results_equal(got, jax_msbfs(case, "hybrid"))


@pytest.mark.parametrize("mode,num_roots,lanes", [("hybrid", 70, 32),
                                                  ("bottomup", 20, 8)])
def test_pipelined_lanes_match_oracle(case, mode, num_roots, lanes):
    g = case.g
    roots = sample_roots(case.jg, num_roots, seed=11)
    out = ms.msbfs_pipelined(g, roots, mode, lanes=lanes)
    rp, ci = to_numpy_adj(g)
    for r_i, root in enumerate(roots):
        pref, dref = bfs_reference(rp, ci, int(root))
        np.testing.assert_array_equal(out.depth[:, r_i].numpy(), dref)
        np.testing.assert_array_equal(out.parent[:, r_i].numpy(), pref)
    validate_bfs_tree(rp, ci, out.parent[:, 0].numpy(), int(roots[0]))


def test_engines_agree_on_multi_component_traces():
    """A lane that finishes early leaves its unused trace rows at init
    values in both engines (mirrors the reference's test)."""
    src = np.concatenate([np.arange(5), np.full(5, 10), np.arange(20, 23)])
    dst = np.concatenate([np.arange(1, 6), np.arange(11, 16),
                          np.arange(21, 24)])
    g = from_edges(src, dst, 24, device="cpu")
    a = ms.msbfs(g, [0, 10], "hybrid")
    b = ms.msbfs_pipelined(g, [0, 10], "hybrid", lanes=2)
    assert_results_same(a, b)
    nl = int(a.num_layers[1])
    assert (a.trace_eu[nl:, 1] == 0).all()
    assert (a.trace_dir[nl:, 1] == -1).all()


def test_engines_agree_at_max_trace_cap():
    """Diameter beyond MAX_TRACE: both engines stop at the serial loop's
    bound with the same truncated depths."""
    n = MAX_TRACE + 10
    v = np.arange(n - 1)
    g = from_edges(v, v + 1, n, device="cpu")
    a = ms.msbfs(g, [0], "topdown")
    b = ms.msbfs_pipelined(g, [0], "topdown", lanes=1)
    s = bfs(g, 0, "topdown")
    assert int(a.num_layers[0]) == int(b.num_layers[0]) \
        == int(s.num_layers) == MAX_TRACE
    assert torch.equal(a.depth[:, 0], s.depth)
    assert torch.equal(b.depth[:, 0], s.depth)
    assert_results_same(a, b)


def jax_fields(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


def assert_states_equal(got, want, what):
    """Every field of two engine states; the trailing column of the out_*
    arrays is the reference's scatter target for lanes that did not
    finish, which the port never writes."""
    cap = got.capacity
    for name in want._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if name.startswith(("out_", "trace_")):
            a, b = a[..., :cap], b[..., :cap]
        np.testing.assert_array_equal(a.view(b.dtype) if a.dtype != b.dtype
                                      and a.dtype.itemsize == b.dtype.itemsize
                                      else a, b, err_msg=f"{name} {what}")


def test_streaming_readout_and_retire_match_reference(case):
    """Roots enqueued mid-sweep, a lane retired once its depth-1 band is
    final, read-outs after every step: the port's engine state equals the
    reference's all the way."""
    jg, g = case.jg, case.g
    roots = sample_roots(jg, 24, seed=15)
    js = jms.msbfs_engine_enqueue(jms.msbfs_engine_init(jg, 24, 8),
                                  jnp.asarray(roots[:8]))
    ts = ms.msbfs_engine_enqueue(ms.msbfs_engine_init(g, 24, 8), roots[:8])
    fed, steps, retired = 8, 0, False
    while fed < 24 or not jms.msbfs_engine_idle(js):
        assert not ms.msbfs_engine_idle(ts)
        js = jms.msbfs_engine_step(jg, js, "hybrid")
        ts = ms.msbfs_engine_step(g, ts, "hybrid")
        steps += 1
        want, got = jms.msbfs_engine_readout(js), ms.msbfs_engine_readout(ts)
        for name in ("layer", "capacity", "lane_qidx", "lane_layer", "depth",
                     "out_depth", "out_layers"):
            a, b = np.asarray(getattr(got, name)), getattr(want, name)
            if name.startswith("out_"):  # not the trailing column
                a, b = a[..., :24], b[..., :24]
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {steps}")
        for q in (0, 9, 23):
            a, b = got.slot_depth(q), want.slot_depth(q)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.slice_words(2),
                                      want.slice_words(2))
        if not retired and got.band_final(1).any():
            mask = got.band_final(1) & (np.arange(8) % 2 == 0)
            js = jms.msbfs_engine_retire(jg, js, jnp.asarray(mask))
            ts = ms.msbfs_engine_retire(g, ts, mask)
            retired = True
        if steps % 2 == 0 and fed < 24:
            js = jms.msbfs_engine_enqueue(js, jnp.asarray(roots[fed:fed + 4]))
            ts = ms.msbfs_engine_enqueue(ts, roots[fed:fed + 4])
            fed += 4
        assert_states_equal(ts, js, f"step {steps}")
    assert retired and ms.msbfs_engine_idle(ts)
    assert_results_equal(ms.msbfs_engine_result(g, ts),
                         jms.msbfs_engine_result(jg, js))


def test_step_from_carried_reference_state(case):
    """A reference state taken mid-sweep and carried into the port steps to
    the same states and the same results."""
    jg, g = case.jg, case.g
    roots = sample_roots(jg, 24, seed=16)
    js = jms.msbfs_engine_enqueue(jms.msbfs_engine_init(jg, 24, 8),
                                  jnp.asarray(roots))
    for _ in range(3):
        js = jms.msbfs_engine_step(jg, js, "hybrid")
    ts = ms.pipeline_state_from_numpy(jax_fields(js), "cpu")
    assert_states_equal(ts, js, "carried")
    while not jms.msbfs_engine_idle(js):
        js = jms.msbfs_engine_step(jg, js, "hybrid")
        ts = ms.msbfs_engine_step(g, ts, "hybrid")
        assert_states_equal(ts, js, f"layer {int(js.sweep_layers)}")
    assert ms.msbfs_engine_idle(ts)
    assert_results_equal(ms.msbfs_engine_result(g, ts),
                         jms.msbfs_engine_result(jg, js))


def test_engine_guards(case):
    g = case.g
    state = ms.msbfs_engine_enqueue(ms.msbfs_engine_init(g, 4, 2),
                                    np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="overflow"):
        ms.msbfs_engine_enqueue(state, np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="capacity"):
        ms.msbfs_engine_init(g, capacity=0)
    with pytest.raises(ValueError, match="lanes"):
        ms.msbfs_engine_init(g, capacity=4, lanes=0)
    with pytest.raises(ValueError, match="lane_mask"):
        ms.msbfs_engine_retire(g, state, np.ones(3, bool))
    with pytest.raises(ValueError, match="mode"):
        ms.msbfs_engine_step(g, state, "sideways")
    with pytest.raises(ValueError, match="at most"):
        ms.msbfs(g, np.zeros(65, np.int32))
    with pytest.raises(ValueError, match="mode"):
        ms.msbfs(g, np.zeros(2, np.int32), "sideways")
    with pytest.raises(ValueError, match="mode"):
        ms.msbfs_pipelined(g, np.zeros(2, np.int32), "sideways")
    with pytest.raises(ValueError, match="at least one root"):
        ms.msbfs_pipelined(g, np.zeros(0, np.int32))
    # recorder= (lifted with the observability layer): the recorded sweep
    # steps the same engine, so its results equal the drain's
    rec = SweepRecorder(engine="msbfs")
    roots = case.roots[:12]
    assert_results_same(ms.msbfs_pipelined(g, roots, lanes=4, recorder=rec),
                        ms.msbfs_pipelined(g, roots, lanes=4), "recorded")
    assert rec.num_layers > 0 and rec.kind == "bfs"
    fresh = ms.msbfs_engine_result(g, ms.msbfs_engine_init(g, 4, 2))
    assert fresh.parent.shape == (g.n, 0) and fresh.num_layers.shape == (0,)


def test_run_graph500_batched_matches_reference(case):
    """The batched harness: the same roots, lanes and traversed edges as
    the reference's, all 40 trees validated."""
    want = jgraph500.run_graph500(9, 16, num_roots=40, seed=0, graph=case.jg,
                                  batched=True, lanes=16)
    got = run_graph500(9, 16, num_roots=40, seed=0, graph=case.g,
                       batched=True, lanes=16, validate=True)
    assert got.roots == [int(r) for r in case.roots]
    assert got.traversed == want.traversed
    s, w = got.summary(), want.summary()
    for key in ("scale", "edgefactor", "mode", "batched", "lanes", "ndev",
                "nroots"):
        assert s[key] == w[key], key
    assert s["device"] == "cpu" and len(got.times) == 1
    assert s["aggregate_teps"] > 0
    adaptive = run_graph500(9, 16, mode="bottomup_simd", num_roots=5, seed=0,
                            graph=case.g, batched=True, lanes=None)
    assert adaptive.mode == "bottomup"
    assert adaptive.lanes == adaptive_lane_pool(5, case.g.n, case.g.m)
    with pytest.raises(ValueError, match="td_impl"):
        run_graph500(9, 16, num_roots=2, graph=case.g, batched=True,
                     td_impl="ell")
