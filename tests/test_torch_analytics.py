"""The port's analytics layer (``repro_torch.analytics``) against
``repro.analytics``.

Three weighted graphs are carried over field by field with
``from_numpy_weighted_graph``: a Graph500 R-MAT graph, a disconnected graph
with isolated vertices and a path. For every query kind in ``QUERY_KINDS``
both packages' ``run_query`` must encode, through ``result_to_wire``, to the
same JSON: bit-equal arrays, the same dtype tags and the same ``QueryMeta``,
with an adaptive lane pool and with a pinned one. The port runs on the CPU
through the kernels' plain versions. Each reference engine is built once per
module.
"""
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro import analytics as ja
from repro.analytics import api as japi
from repro.analytics import khop as jkhop
from repro.core.csr import from_weighted_edges as jfrom_weighted_edges
from repro.graph.generator import rmat_weighted_graph as jrmat_weighted
from repro.graph.sampler import khop_node_sets as jkhop_node_sets
from repro.obs import Telemetry as JTelemetry
from repro_torch import analytics as ta
from repro_torch.analytics import api as tapi
from repro_torch.analytics import engine as tengine
from repro_torch.analytics import khop as tkhop
from repro_torch.benchmarks import analytics_bench
from repro_torch.core.csr import from_numpy_graph, from_numpy_weighted_graph
from repro_torch.core.packed import depth_slice_words
from repro_torch.graph.sampler import khop_node_sets
from repro_torch.obs import Telemetry as TTelemetry

PINNED_LANES = 64


def port_graph(jwg):
    return from_numpy_weighted_graph(
        np.asarray(jwg.row_ptr), np.asarray(jwg.col_idx),
        np.asarray(jwg.src_idx), np.asarray(jwg.weights), "cpu")


def weighted_edges(src, dst, n, seed):
    w = np.random.default_rng(seed).uniform(0.0, 1.0, size=len(src))
    return jfrom_weighted_edges(np.asarray(src), np.asarray(dst), w, n)


def disconnected_graph():
    """A 10-cycle, a 6-star, a 5-clique and a 3-path among 48 vertices;
    the other 24 are isolated."""
    cyc = [(i, (i + 1) % 10) for i in range(10)]
    star = [(10, 11 + i) for i in range(5)]
    clique = [(a, b) for a in range(16, 21) for b in range(a + 1, 21)]
    path = [(40, 41), (41, 42)]
    src, dst = zip(*(cyc + star + clique + path))
    return weighted_edges(src, dst, 48, seed=5)


def path_graph(n=16):
    return weighted_edges(np.arange(n - 1), np.arange(1, n), n, seed=6)


GRAPHS = {
    "rmat": lambda: jrmat_weighted(7, 8, seed=0),
    "disconnected": disconnected_graph,
    "path": path_graph,
}

# (id, kind, query arguments); sources are clipped to each graph's n. Most
# sweeps take 4 roots, so the reference compiles few sweep shapes.
QUERIES = [
    ("components", "components", {}),
    ("components_b4", "components", dict(batch=4)),
    ("closeness_auto", "closeness", {}),
    ("closeness_sampled", "closeness", dict(sources=9, seed=3, chunk=4)),
    ("bfs", "bfs", dict(sources=(3, 9, 15, 0))),
    ("khop", "khop", dict(sources=(3, 9, 15, 0), k=2)),
    ("reach", "reach", dict(sources=(3, 9, 15, 4), targets=(0, 5, 9, 14))),
    ("reach_all_pairs", "reach", dict(sources=(1, 2, 7, 8))),
    ("diameter", "diameter", {}),
    ("sssp", "sssp", dict(sources=(3, 9, 15, 0))),
    ("weighted_closeness", "weighted_closeness",
     dict(sources=7, seed=1, chunk=4)),
    ("weighted_closeness_auto", "weighted_closeness", {}),
]


def test_query_kinds_match_reference():
    assert list(ta.QUERY_KINDS) == list(ja.QUERY_KINDS)
    for kind, qtype in ta.QUERY_KINDS.items():
        ref = ja.QUERY_KINDS[kind]
        assert qtype.__name__ == ref.__name__
        assert [f.name for f in dataclasses.fields(qtype)] == \
            [f.name for f in dataclasses.fields(ref)]
        assert ta.query_kind(qtype) == kind
    covered = {kind for _, kind, _ in QUERIES}
    assert covered == set(ta.QUERY_KINDS)


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, build in GRAPHS.items():
        jg = build()
        out[name] = SimpleNamespace(jg=jg, g=port_graph(jg), engines={})
    return out


def engines(case, lanes):
    if lanes not in case.engines:
        case.engines[lanes] = (ja.LaneEngine(case.jg, lanes=lanes),
                               ta.LaneEngine(case.g, lanes=lanes))
    return case.engines[lanes]


def query_args(args, n):
    def clip(v):
        return tuple(int(x) % n for x in v) if isinstance(v, tuple) else v
    return {k: clip(v) for k, v in args.items()}


def wire_json(api, result):
    return json.dumps(api.result_to_wire(result), sort_keys=True)


@pytest.mark.parametrize("lanes", [None, PINNED_LANES],
                         ids=["adaptive", f"lanes{PINNED_LANES}"])
@pytest.mark.parametrize("qid,kind,args", QUERIES, ids=[q[0] for q in QUERIES])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_run_query_wire_matches_reference(graphs, graph, qid, kind, args,
                                          lanes):
    case = graphs[graph]
    jeng, teng = engines(case, lanes)
    args = query_args(args, case.g.n)
    want = ja.run_query(jeng, ja.QUERY_KINDS[kind](**args))
    got = ta.run_query(teng, ta.QUERY_KINDS[kind](**args))
    assert type(got).__name__ == type(want).__name__
    assert wire_json(tapi, got) == wire_json(japi, want)
    back = tapi.result_from_wire(json.loads(wire_json(tapi, got)))
    assert wire_json(tapi, back) == wire_json(tapi, got)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_khop_words_and_members_match_reference(graphs, graph):
    case = graphs[graph]
    jeng, teng = engines(case, None)
    sources = [0, 1, case.g.n // 3, case.g.n - 1]
    want = ja.khop_neighborhood(jeng, sources, 3)
    got = ta.khop_neighborhood(teng, sources, 3)
    assert got.words.dtype == np.uint32
    np.testing.assert_array_equal(got.words, np.asarray(want.words))
    np.testing.assert_array_equal(got.member_mask(), want.member_mask())
    for lane in range(len(sources)):
        np.testing.assert_array_equal(got.members(lane), want.members(lane))
    # the words are the engines' own lane-word layout
    np.testing.assert_array_equal(
        got.words.view(np.int32),
        depth_slice_words(torch.from_numpy(got.depth), 3).numpy())


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_khop_node_sets_match_reference(graphs, graph):
    case = graphs[graph]
    seeds = [0, 2, case.g.n // 2, case.g.n - 2]
    want_sets, want = jkhop_node_sets(case.jg.csr, seeds, 2)
    got_sets, got = khop_node_sets(case.g.csr, seeds, 2)
    assert len(got_sets) == len(want_sets)
    for a, b in zip(got_sets, want_sets):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert wire_json(tapi, got) == wire_json(japi, want)


@pytest.mark.parametrize("roots,width", [([5], 4), ([3, 1, 2], 3),
                                         ([7, 8], 6)])
def test_pad_roots_matches_reference(roots, width):
    got = tengine.pad_roots(np.array(roots), width)
    want = ja.engine.pad_roots(np.array(roots), width)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_pad_roots_refuses_over_width():
    with pytest.raises(ValueError, match="exceed the fixed sweep width"):
        tengine.pad_roots(np.arange(5), 4)


def test_as_engine_refuses_overrides(graphs):
    case = graphs["path"]
    eng = ta.as_engine(case.g, lanes=32)
    assert ta.as_engine(eng) is eng and eng.lanes == 32
    with pytest.raises(ValueError) as got:
        ta.as_engine(eng, lanes=64)
    with pytest.raises(ValueError) as want:
        ja.as_engine(ja.as_engine(case.jg, lanes=32), lanes=64)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kwargs,exc,match", [
    # the sharded engines run on the ranks of a process group; without one
    # they say how to launch
    (dict(ndev=2), RuntimeError, "run_ranks"),
    (dict(grid=(2, 1)), RuntimeError, "run_ranks"),
    # the wire codec is the 2-D exchange's knob, as in the reference
    (dict(compress=True), ValueError, r"grid=\(pr, pc\)"),
    (dict(grid=(2, 2), ndev=4), RuntimeError, "run_ranks")])
def test_unported_engine_knobs_raise(graphs, kwargs, exc, match):
    with pytest.raises(exc, match=match):
        ta.LaneEngine(graphs["path"].g, **kwargs)


def test_telemetry_records_one_sweep_per_query(graphs):
    """``LaneEngine(telemetry=)``: every sweep of a query is recorded, as
    the reference's engine records it (every ``LayerRecord`` field but
    ``wall_ms``), and the answers equal an unrecorded engine's."""
    case = graphs["rmat"]
    queries = [("khop", dict(sources=(3, 9, 15, 0), k=2)),
               ("sssp", dict(sources=(3, 9, 15, 0)))]
    recorded = {}
    for api, eng_cls, tel in ((ta, ta.LaneEngine, TTelemetry()),
                              (ja, ja.LaneEngine, JTelemetry())):
        eng = eng_cls(case.jg if api is ja else case.g, telemetry=tel)
        wires = [wire_json(tapi if api is ta else japi,
                           api.run_query(eng, api.QUERY_KINDS[k](**a)))
                 for k, a in queries]
        recorded[api] = (wires, tel)
    wires, tel = recorded[ta]
    assert [r.engine for r in tel.sweeps] == ["msbfs", "sssp"]
    assert all(r.meta == {"ndev": 1} and r.num_layers > 0 for r in tel.sweeps)
    plain = ta.LaneEngine(case.g)
    assert wires == [wire_json(tapi, ta.run_query(plain, ta.QUERY_KINDS[k](
        **a))) for k, a in queries]
    jwires, jtel = recorded[ja]
    assert wires == jwires

    def fields(t):
        return [[{k: v for k, v in r.as_dict().items() if k != "wall_ms"}
                 for r in s.records] for s in t.sweeps]
    assert fields(tel) == fields(jtel)


def test_weighted_query_on_unweighted_engine_raises(graphs):
    eng = ta.LaneEngine(graphs["path"].g.csr)
    assert not eng.weighted
    with pytest.raises(TypeError, match="unweighted engine"):
        ta.run_query(eng, ta.SSSPQuery(sources=(0,)))


def test_bad_mode_raises(graphs):
    with pytest.raises(ValueError, match="mode must be one of"):
        ta.LaneEngine(graphs["path"].g, mode="bogus")


@pytest.mark.parametrize("qid,kind,args", [q for q in QUERIES
                                           if q[0] in ("khop", "closeness_auto",
                                                       "sssp")],
                         ids=["closeness_auto", "khop", "sssp"])
def test_request_and_answer_wire_round_trip(graphs, qid, kind, args):
    case = graphs["disconnected"]
    args = query_args(args, case.g.n)
    req = ta.AnalyticsRequest(query=ta.QUERY_KINDS[kind](**args), id="r1",
                              tenant="t", arrival=3)
    jreq = ja.AnalyticsRequest(query=ja.QUERY_KINDS[kind](**args), id="r1",
                               tenant="t", arrival=3)
    assert req.to_wire() == jreq.to_wire()
    again = ta.AnalyticsRequest.from_wire(json.loads(json.dumps(
        req.to_wire())))
    assert again == req
    ans = ta.answer_request(engines(case, None)[1], req)
    assert ans.id == "r1" and ans.meta is ans.result.meta
    wire = json.loads(json.dumps(ans.to_wire(include_result=True)))
    back = ta.AnalyticsAnswer.from_wire(wire)
    assert back.id == ans.id and back.meta == ans.meta
    assert wire_json(tapi, back.result) == wire_json(tapi, ans.result)
    summary = ans.to_wire()
    assert summary["kind"] == kind and "result" not in summary
    with pytest.raises(ValueError, match="summary envelope"):
        ta.AnalyticsAnswer.from_wire(summary)


def test_unknown_tags_raise():
    with pytest.raises(ValueError, match="unknown query tag"):
        ta.AnalyticsRequest.from_wire({"kind": "nope"})
    with pytest.raises(ValueError, match="unknown result type"):
        tapi.result_from_wire({"type": "Nope"})
    with pytest.raises(TypeError, match="unknown analytics query type"):
        ta.AnalyticsRequest(query=object())


def test_analytics_bench_main_on_cpu(capsys):
    points = analytics_bench.main(["--scale", "6", "--device", "cpu"])
    # 61 of the 64 vertices have edges: sample_roots draws from those
    assert set(points) == {"components_s6", "closeness_s6_k64",
                           "khop_s6_S61_k2"}
    assert all(teps > 0 for teps in points.values())
    assert "MTEPS-equiv" in capsys.readouterr().out


def test_analytics_bench_ndev_raises():
    """``--ndev 2`` shards the engine, which runs on the ranks of a
    process group: outside one it raises and says how to launch."""
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        analytics_bench.bench_points(6, device="cpu", ndev=2)


@pytest.mark.parametrize("lanes", [1, 31, 32, 33, 70])
def test_khop_result_from_depth_matches_reference(lanes):
    """Lane counts at and across the word boundary: bit 31 is int32's sign
    bit, which the words keep as uint32."""
    depth = np.random.default_rng(lanes).integers(-1, 5, (9, lanes),
                                                  dtype=np.int32)
    sources = np.arange(lanes, dtype=np.int32)
    want = jkhop.khop_result_from_depth(sources, 2, depth, ja.QueryMeta())
    got = tkhop.khop_result_from_depth(sources, 2, depth, ta.QueryMeta())
    assert got.words.dtype == np.uint32
    assert got.words.shape == (9, (lanes + 31) // 32)
    np.testing.assert_array_equal(got.words, np.asarray(want.words))
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.member_mask(), (depth >= 0)
                                  & (depth <= 2))
    assert wire_json(tapi, got) == wire_json(japi, want)


def test_unweighted_graph_engine_serves_boolean_queries(graphs):
    case = graphs["rmat"]
    g = from_numpy_graph(np.asarray(case.jg.row_ptr),
                         np.asarray(case.jg.col_idx),
                         np.asarray(case.jg.src_idx), "cpu")
    got = ta.run_query(g, ta.BFSQuery(sources=(3, 9)))
    want = ta.run_query(engines(case, None)[1], ta.BFSQuery(sources=(3, 9)))
    assert wire_json(tapi, got) == wire_json(tapi, want)
