"""The port's delta-stepping engine against ``repro.traversal.sssp``.

The same weighted graph (carried over field by field), sources and
arguments go through both packages; all six ``SSSPResult`` fields must be
equal, bit for bit, to the reference's default path (``relax_impl="xla"``,
which the reference's kernel path equals bit for bit), whichever of its
two plain paths the port takes on the CPU. The stepping API's states are
compared too, from a reference state carried across mid-sweep
(``sssp_state_from_numpy``). The reference's results are built once per
module: each of its configurations compiles a whole sweep.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as jcsr
from repro.graph import generator as jgen
from repro.traversal import sssp as jsssp
from repro_torch.core.csr import from_numpy_weighted_graph, from_weighted_edges
from repro_torch.core.msbfs import msbfs_pipelined
from repro_torch.obs import SweepRecorder
from repro_torch.traversal import sssp as ss
from repro_torch.traversal.ref import dijkstra_reference, to_numpy_weighted

FIELDS = ss.SSSPResult._fields
IMPLS = ("xla", "pallas")


def port_graph(jwg):
    return from_numpy_weighted_graph(
        *(np.asarray(getattr(jwg, f))
          for f in ("row_ptr", "col_idx", "src_idx", "weights")), "cpu")


def assert_results_equal(got, want, what=""):
    for name in FIELDS:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, f"{name} {what}"
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8),
                                      err_msg=f"{name} {what}")


def assert_matches_dijkstra(wg, roots, dist, atol=1e-4):
    rp, ci, w = to_numpy_weighted(wg)
    for i, r in enumerate(roots):
        ref = dijkstra_reference(rp, ci, w, int(r))
        got = dist[:, i].numpy().astype(np.float64)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], atol=atol)


@pytest.fixture(scope="module")
def case():
    rmat = jgen.rmat_weighted_graph(8, 8, seed=0)
    uni = jgen.uniform_random_weighted_graph(120, 600, seed=10)
    return SimpleNamespace(
        jg={"rmat": rmat, "uniform": uni},
        g={"rmat": port_graph(rmat), "uniform": port_graph(uni)},
        roots={"rmat": jgen.sample_roots(rmat, 8, seed=1),
               "uniform": np.array([0, 5, 17, 33, 119], np.int32)},
        cache={})


def reference(case, key, fn):
    if key not in case.cache:
        case.cache[key] = fn()
    return case.cache[key]


# (graph, delta, lanes): scalar widths from tiny (almost every edge heavy)
# to huge (every edge light: Bellman-Ford), the default width, and a
# per-lane tuple; fewer lanes than sources, so lanes refill
SWEEPS = [("rmat", None, 4), ("rmat", 0.02, 3),
          ("rmat", (0.03, 0.2, 0.03, 1.0), 4), ("uniform", 50.0, 2)]


@pytest.mark.parametrize("graph,delta,lanes", SWEEPS,
                         ids=lambda p: str(p).replace(" ", ""))
def test_sssp_pipelined_matches_reference(case, graph, delta, lanes):
    jg, g, roots = case.jg[graph], case.g[graph], case.roots[graph]
    want = reference(case, ("pipelined", graph, delta, lanes),
                     lambda: jsssp.sssp_pipelined(jg, roots, delta=delta,
                                                  lanes=lanes))
    for impl in IMPLS:
        got = ss.sssp_pipelined(g, roots, delta=delta, lanes=lanes,
                                relax_impl=impl)
        assert_results_equal(got, want, impl)
    assert not got.truncated.any()
    assert_matches_dijkstra(g, roots, got.dist)


def test_default_and_adaptive_delta_match_reference(case):
    for name, jg in case.jg.items():
        g = case.g[name]
        assert ss.default_delta(g) == jsssp.default_delta(jg)
        assert ss.adaptive_delta(g) == jsssp.adaptive_delta(jg)
        assert ss.adaptive_delta(g, 3) == jsssp.adaptive_delta(jg, 3)
    # a dense graph with a bimodal weight histogram, where the adaptive
    # width leaves the default: light local edges, a heavy long-haul mode
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 50, 2000), rng.integers(0, 50, 2000)
    w = np.where(rng.random(2000) < 0.5, rng.uniform(0.001, 0.0012, 2000),
                 rng.uniform(1.0, 1.1, 2000))
    jg = jcsr.from_weighted_edges(src, dst, w, 50)
    g = from_weighted_edges(src, dst, w, 50, device="cpu")
    assert ss.adaptive_delta(g) == jsssp.adaptive_delta(jg)
    assert ss.adaptive_delta(g) != ss.default_delta(g)
    edgeless = from_weighted_edges(np.zeros(0), np.zeros(0), np.zeros(0), 4,
                                   device="cpu")
    assert ss.default_delta(edgeless) == 1.0


def test_step_cap_marks_truncated_like_reference(case):
    jg, g = case.jg["uniform"], case.g["uniform"]
    roots = [0, 1, 2]
    want = reference(case, "capped", lambda: jsssp.sssp_pipelined(
        jg, roots, delta=0.5, lanes=2, max_steps=3))
    for impl in IMPLS:
        got = ss.sssp_pipelined(g, roots, delta=0.5, lanes=2, max_steps=3,
                                relax_impl=impl)
        assert_results_equal(got, want, impl)
    assert got.truncated.all()
    np.testing.assert_array_equal(got.steps.numpy(), [3, 3, 3])


def test_streaming_enqueue_mid_sweep_matches_reference(case):
    """Sources enqueued while lanes are mid-flight land in idle lanes; the
    stepped sweep equals the reference's stepped sweep and the port's
    one-shot sweep."""
    jg, g, roots = case.jg["rmat"], case.g["rmat"], case.roots["rmat"][:6]
    delta = ss.default_delta(g)

    def stepped(init, enqueue, step, drain, result, wg):
        s = enqueue(init(wg, capacity=len(roots), lanes=2), roots[:3])
        for _ in range(3):
            s = step(wg, s, delta)
        return result(drain(wg, enqueue(s, roots[3:]), delta))

    want = reference(case, "streaming", lambda: stepped(
        jsssp.sssp_engine_init, jsssp.sssp_engine_enqueue,
        jsssp.sssp_engine_step, jsssp.sssp_engine_drain,
        jsssp.sssp_engine_result, jg))
    got = stepped(ss.sssp_engine_init, ss.sssp_engine_enqueue,
                  ss.sssp_engine_step, ss.sssp_engine_drain,
                  ss.sssp_engine_result, g)
    assert_results_equal(got, want)
    one_shot = ss.sssp_pipelined(g, roots, delta=delta, lanes=2)
    assert torch.equal(got.dist, one_shot.dist)


def state_fields(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def test_state_carried_across_mid_sweep(case):
    """A reference state after k steps, carried into the port, steps on to
    the same states and the same result. The trailing trash column of the
    out_* arrays (written by the reference only) is left out."""
    jg, g, roots = case.jg["rmat"], case.g["rmat"], case.roots["rmat"][:6]
    delta = jsssp.default_delta(jg)

    def reference_states():
        # the streaming test's shapes, so the reference compiles once
        s = jsssp.sssp_engine_enqueue(
            jsssp.sssp_engine_init(jg, capacity=len(roots), lanes=2), roots)
        states = []
        for _ in range(12):
            s = jsssp.sssp_engine_step(jg, s, delta)
            states.append(state_fields(s))
        final = jsssp.sssp_engine_result(jsssp.sssp_engine_drain(jg, s,
                                                                 delta))
        return states, final

    states, final = reference(case, "states", reference_states)
    s = ss.sssp_state_from_numpy(states[6], "cpu")
    cap = len(roots)
    for want in states[7:]:
        s = ss.sssp_engine_step(g, s, delta)
        for name in ("dist", "relaxed", "out_dist"):
            np.testing.assert_array_equal(
                getattr(s, name).numpy()[:, :cap if name == "out_dist"
                                         else None], want[name][:, :cap]
                if name == "out_dist" else want[name], err_msg=name)
        for name in ("lane_bucket", "lane_steps", "lane_qidx", "queue",
                     "queued", "next_root", "sweep_steps"):
            np.testing.assert_array_equal(getattr(s, name), want[name],
                                          err_msg=name)
        for name in ("out_steps", "out_truncated", "trace_bucket",
                     "trace_phase"):
            np.testing.assert_array_equal(getattr(s, name)[..., :cap],
                                          want[name][..., :cap],
                                          err_msg=name)
    assert_results_equal(ss.sssp_engine_result(
        ss.sssp_engine_drain(g, s, delta)), final)


def test_zero_weight_edges_match_reference(case):
    """Zero-weight edges collapse distances inside the light fixpoint."""
    src, dst = np.asarray([0, 1, 2, 0]), np.asarray([1, 2, 3, 2])
    w = np.asarray([1.0, 1.0, 1.0, 0.0])
    jg = jcsr.from_weighted_edges(src, dst, w, 5)
    g = from_weighted_edges(src, dst, w, 5, device="cpu")
    want = reference(case, "zero", lambda: jsssp.sssp_pipelined(
        jg, [0, 4], delta=0.5))
    got = ss.sssp_pipelined(g, [0, 4], delta=0.5)
    assert_results_equal(got, want)
    np.testing.assert_array_equal(got.dist[:4, 0].numpy(), [0, 1, 0, 1])
    assert not torch.isfinite(got.dist[4, 0])


def test_bad_arguments_raise(case):
    g = case.g["rmat"]
    for bad in (0.0, -1.0, ()):
        with pytest.raises(ValueError, match="delta"):
            ss.sssp_engine_step(g, ss.sssp_engine_init(g, 1), bad)
    with pytest.raises(ValueError, match="per-lane delta"):
        ss.sssp_pipelined(g, [0, 1, 2], delta=(0.1, 0.2), lanes=3)
    with pytest.raises(ValueError, match="at least one source"):
        ss.sssp_pipelined(g, [])
    with pytest.raises(ValueError, match="queue overflow"):
        ss.sssp_engine_enqueue(ss.sssp_engine_init(g, 1), [0, 1])
    # recorder= (lifted with the observability layer): the recorded sweep
    # steps the same engine, so its results equal the drain's
    rec = SweepRecorder(engine="sssp")
    roots = case.roots["rmat"][:5]
    assert_results_equal(ss.sssp_pipelined(g, roots, lanes=2, recorder=rec),
                         ss.sssp_pipelined(g, roots, lanes=2), "recorded")
    assert rec.num_layers > 0 and rec.kind == "sssp"


def test_unit_weight_anchor_matches_msbfs(case):
    """Unit weights at delta = 1: bucket b is BFS layer b, so the depths
    equal the port's own msbfs_pipelined's, with lane refills."""
    g = case.g["rmat"]
    unit = from_weighted_edges(g.src_idx.numpy(), g.col_idx.numpy(),
                               np.ones(g.m), g.n, symmetrize=False,
                               drop_self_loops=False, device="cpu")
    roots = case.roots["rmat"]
    res = ss.sssp_pipelined(unit, roots, delta=1.0, lanes=3)
    depth = msbfs_pipelined(unit.csr, roots, "hybrid", lanes=32,
                            derive_parents=False).depth
    assert torch.equal(res.as_depth(), depth)
    assert torch.equal(res.reached(), depth >= 0)


def reciprocal_cases(deltas, ks=range(2, 80)):
    """Per delta, one float32 x > delta where floor(x / d) and
    floor(x * f32(1/d)) differ in float32, or None."""
    out = []
    for d in deltas:
        d32 = np.float32(d)
        r = np.float32(1) / d32
        found = None
        for k in ks:
            x0 = np.float32(k) * d32
            for x in (np.nextafter(x0, np.float32(0)), x0,
                      np.nextafter(x0, np.float32(np.inf))):
                if np.floor(x / d32) != np.floor(x * r):
                    found = x
                    break
            if found is not None:
                break
        out.append(found)
    return out


def test_bucket_advance_multiplies_by_reciprocal(case):
    """XLA compiles the reference's floor(min_unsettled / delta) into
    floor(min_unsettled * f32(1/delta)). One lane per source: source 2i
    has one heavy edge of weight x_i to 2i+1, chosen so that division and
    the reciprocal product floor differently; after the settle step the
    lane's bucket (trace row 2) is the reciprocal's, in both packages,
    with a scalar delta and with a per-lane tuple."""
    deltas = (0.1, 0.3, 0.7, 1.0 / 3.0, 0.07)
    xs = reciprocal_cases(deltas)
    assert all(x is not None for x in xs)
    k = len(deltas)
    src, dst = 2 * np.arange(k), 2 * np.arange(k) + 1
    roots = 2 * np.arange(k)
    for delta in (deltas[1], deltas):
        d = (deltas if isinstance(delta, tuple)
             else (delta,) * k)
        ws = xs if isinstance(delta, tuple) else reciprocal_cases(d)
        if any(x is None for x in ws):
            continue
        w = np.asarray(ws, np.float64)
        jg = jcsr.from_weighted_edges(src, dst, w, 2 * k)
        g = from_weighted_edges(src, dst, w, 2 * k, device="cpu")
        want = reference(case, ("recip", delta), lambda: jsssp.sssp_pipelined(
            jg, jnp.asarray(roots), delta=delta, lanes=k))
        got = ss.sssp_pipelined(g, roots, delta=delta, lanes=k)
        assert_results_equal(got, want, str(delta))
        bucket = got.trace_bucket[2].numpy()
        for i in range(k):
            x, d32 = np.float32(ws[i]), np.float32(d[i])
            assert bucket[i] == max(int(np.floor(x * (np.float32(1) / d32))),
                                    1)
            assert np.floor(x / d32) != np.floor(x * (np.float32(1) / d32))
