"""The port's observability layer (``repro_torch.obs``) against
``repro.obs``.

The sweep recorders of ``msbfs_pipelined`` and ``sssp_pipelined`` must
emit the reference's ``LayerRecord`` stream (every field but ``wall_ms``,
the host clock) on the same graph and roots, rebuild the engines' traces
exactly, and leave the results bit-identical to the unrecorded drain; with
``recorder=None`` nothing of ``repro_torch.obs.sweeplog`` runs. The metrics
registry's text, the SLO monitor's view, the serving stats and the Chrome
trace events must equal the reference's over the same operations, and a
service replay must expose the reference's metrics text and request trace.
The port runs on the CPU through the kernels' plain versions; the
reference's sweeps and replay are built once per module.
"""
import json
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.msbfs import msbfs_pipelined as jmsbfs_pipelined
from repro.graph.generator import rmat_weighted_graph as jrmat_weighted
from repro.serving import AnalyticsService as JService
from repro.serving import stats as jstats
from repro.serving import synthetic_trace as jsynthetic_trace
from repro.traversal.sssp import sssp_pipelined as jsssp_pipelined
from repro_torch import obs
from repro_torch.core.csr import from_numpy_weighted_graph
from repro_torch.core.hybrid import MAX_TRACE
from repro_torch.core.msbfs import msbfs_pipelined
from repro_torch.serving import AnalyticsService, stats, synthetic_trace
from repro_torch.traversal.sssp import MAX_SSSP_TRACE, sssp_pipelined

MIX = "bfs:3,khop:2,reach:1,sssp:1"


def port_graph(jwg):
    return from_numpy_weighted_graph(
        *(np.asarray(getattr(jwg, f))
          for f in ("row_ptr", "col_idx", "src_idx", "weights")), "cpu")


def record_fields(records):
    return [{k: v for k, v in r.as_dict().items() if k != "wall_ms"}
            for r in records]


def traces(case):
    want = jsynthetic_trace(case.jwg.csr.n, 16, mix=MIX, seed=2, burst=4)
    got = synthetic_trace(case.wg.n, 16, mix=MIX, seed=2, burst=4)
    for i, (a, b) in enumerate(zip(want, got)):
        a.id = b.id = f"r{i}"
    return want, got


@pytest.fixture(scope="module")
def case():
    jwg = jrmat_weighted(8, 8, seed=11)
    c = SimpleNamespace(jwg=jwg, wg=port_graph(jwg),
                        roots=np.arange(24, dtype=np.int32) * 7 % 256,
                        sources=np.arange(10, dtype=np.int32) * 13 % 256)
    c.jbfs = jobs.SweepRecorder(engine="msbfs")
    jmsbfs_pipelined(jwg.csr, c.roots, lanes=8, recorder=c.jbfs)
    c.jsssp = jobs.SweepRecorder(engine="sssp")
    jsssp_pipelined(jwg, c.sources, lanes=4, recorder=c.jsssp)
    jtrace, _ = traces(c)
    c.jsvc = JService(jwg, slots=16, sssp_slots=4,
                      telemetry=jobs.Telemetry())
    c.jsvc.replay(jtrace)
    return c


# ---------------------------------------------------------------------------
# sweep recorders
# ---------------------------------------------------------------------------


def test_msbfs_recorder_matches_reference(case):
    g = case.wg.csr
    rec = obs.SweepRecorder(engine="msbfs")
    got = msbfs_pipelined(g, case.roots, lanes=8, recorder=rec)
    base = msbfs_pipelined(g, case.roots, lanes=8)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(base, f)), f
    assert record_fields(rec.records) == record_fields(case.jbfs.records)
    tr = rec.reconstruct_traces(MAX_TRACE, case.roots.size)
    for f in ("trace_dir", "trace_vf", "trace_ef", "trace_eu"):
        np.testing.assert_array_equal(tr[f], getattr(base, f).numpy(),
                                      err_msg=f)
    assert rec.summary()["layers"] == case.jbfs.summary()["layers"]
    assert all(r.wall_ms > 0 for r in rec.records)


def test_sssp_recorder_matches_reference(case):
    rec = obs.SweepRecorder(engine="sssp")
    got = sssp_pipelined(case.wg, case.sources, lanes=4, recorder=rec)
    base = sssp_pipelined(case.wg, case.sources, lanes=4)
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(base, f)), f
    assert record_fields(rec.records) == record_fields(case.jsssp.records)
    tr = rec.reconstruct_traces(MAX_SSSP_TRACE, case.sources.size)
    for f in ("trace_bucket", "trace_phase"):
        np.testing.assert_array_equal(tr[f], getattr(base, f).numpy(),
                                      err_msg=f)
    assert set(rec.modes()) <= {"light", "heavy", "mixed", "idle"}


def test_recorder_off_never_touches_sweeplog(case):
    """With ``recorder=None`` the drivers, the engine and a service with no
    telemetry never call into ``repro_torch.obs.sweeplog``: the snapshot
    hook is poisoned, and a live recorder does hit it."""
    boom = mock.patch("repro_torch.obs.sweeplog.snapshot_state",
                      side_effect=AssertionError("obs touched"))
    with boom:
        msbfs_pipelined(case.wg.csr, case.roots[:6], lanes=8)
        sssp_pipelined(case.wg, case.sources[:3], lanes=2)
        from repro_torch.analytics import KHopQuery, LaneEngine, run_query
        run_query(LaneEngine(case.wg), KHopQuery(sources=(1, 2), k=2))
        _, trace = traces(case)
        AnalyticsService(case.wg, slots=16, sssp_slots=4).replay(trace[:6])
    with boom, pytest.raises(AssertionError, match="obs touched"):
        msbfs_pipelined(case.wg.csr, case.roots[:6], lanes=8,
                        recorder=obs.SweepRecorder(engine="msbfs"))


# ---------------------------------------------------------------------------
# metrics, SLOs, serving stats
# ---------------------------------------------------------------------------


def registry_ops(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("req_total", "requests", ("kind", "status"))
    c.labels(kind="bfs", status="DONE").inc()
    c.labels(kind="khop", status="REJECTED").inc(2.5)
    reg.counter("plain_total").inc(3)
    g = reg.gauge("depth", "queue depth")
    g.set(7), g.inc(2), g.dec(0.5)
    h = reg.histogram("sojourn", "layers", ("kind",), buckets=(1, 4, 16))
    for v in (0.5, 1, 3, 17, 100):
        h.labels(kind="bfs").observe(v)
    reg.histogram("wall_ms", "ms").observe(0.25)
    assert reg.counter("req_total", "requests", ("kind", "status")) is c
    errors = []
    for bad in (lambda: reg.gauge("req_total"),
                lambda: c.labels(kind="x"),
                lambda: c.inc(),
                lambda: c.labels(kind="a", status="b").inc(-1),
                lambda: mod.Counter("bad name!")):
        with pytest.raises(ValueError) as e:
            bad()
        errors.append(str(e.value))
    small = mod.Counter("ids_total", labelnames=("id",), max_series=2)
    small.labels(id=1).inc(), small.labels(id=2).inc()
    with pytest.raises(ValueError) as e:
        small.labels(id=3)
    errors.append(str(e.value))
    return mod.metrics_text(reg), errors


def test_metrics_registry_matches_reference():
    from repro.obs import metrics as jmetrics
    from repro_torch.obs import metrics
    assert registry_ops(metrics) == registry_ops(jmetrics)


def slo_ops(mod):
    reg = mod.MetricsRegistry()
    mon = mod.SLOMonitor(mod.SLOConfig(p99_sojourn_layers=4.0,
                                       max_queue_depth=3,
                                       max_reject_rate=0.25, window=8),
                         reg)
    views = []
    for i, (admitted, sojourn, depth) in enumerate(
            [(True, 1, 0), (True, 5, 4), (False, 2, 1), (True, 3, 0),
             (False, 9, 5), (True, 1, 1), (True, 2, 0)] * 2):
        mon.observe_admission(admitted)
        mon.observe_sojourn(sojourn)
        mon.observe_queue_depth(depth)
        views.append(mon.snapshot() if i % 2 else mon.peek())
    return views, mon.breaches, reg.expose()


def test_slo_monitor_matches_reference():
    assert slo_ops(obs) == slo_ops(jobs)
    with pytest.raises(ValueError, match="window"):
        obs.SLOConfig(window=0)


def test_serving_stats_match_reference():
    rng = np.random.default_rng(4)
    xs = rng.integers(0, 50, 37).tolist()
    for p in (1, 25, 50, 95, 99, 100):
        assert stats.percentile(xs, p) == jstats.percentile(xs, p)
    assert stats.percentile([], 50) == jstats.percentile([], 50) == 0.0
    assert stats.sojourn_summary(xs) == jstats.sojourn_summary(xs)
    recs = [SimpleNamespace(kind=k, status=s, sojourn=int(j),
                            answered_early=bool(j % 2), lanes_used=int(j % 3))
            for k, s, j in zip(["bfs", "khop", "sssp"] * 5,
                               ["DONE"] * 13 + ["REJECTED"] * 2, xs)]
    kw = dict(layers=40, wall_s=1.25, edges=10 ** 6, lanes=32, ndev=1,
              occupancy=xs[:9], sssp_steps=12, delta=0.5)
    assert stats.summarize(recs, **kw) == jstats.summarize(recs, **kw)


# ---------------------------------------------------------------------------
# the service's metrics text and trace events, the trace-event tools
# ---------------------------------------------------------------------------


def test_service_metrics_and_trace_events_match_reference(case):
    _, trace = traces(case)
    tel = obs.Telemetry()
    svc = AnalyticsService(case.wg, slots=16, sssp_slots=4, telemetry=tel)
    svc.replay(trace)
    assert svc.metrics_text() == case.jsvc.metrics_text()
    got = obs.service_trace_events(list(svc._records.values()))
    want = jobs.service_trace_events(list(case.jsvc._records.values()))
    assert got == want
    assert [record_fields(s.records) for s in tel.sweeps] == \
        [record_fields(s.records) for s in case.jsvc.telemetry.sweeps]
    events = obs.validate_trace_events(svc.trace_events())
    assert len(events) > len(got)   # one process per recorded sweep
    # the sweep spans: the same records give the reference's events
    for rec in tel.sweeps:
        assert obs.sweep_trace_events(rec, pid=3) == \
            jobs.sweep_trace_events(rec, pid=3)


def test_trace_event_tools(tmp_path, case):
    rec = obs.SweepRecorder(engine="msbfs")
    msbfs_pipelined(case.wg.csr, case.roots[:8], lanes=8, recorder=rec)
    events = obs.sweep_trace_events(rec)
    path = obs.write_chrome_trace(str(tmp_path / "t.json"), events)
    with open(path) as f:
        assert json.load(f)["traceEvents"] == events
    bad = [dict(name="x", ph="Q", pid=1, tid=1), dict(name="x", ph="X",
                                                       pid=1, tid=1, ts=0)]
    for ev in bad:
        with pytest.raises(ValueError) as got:
            obs.validate_trace_events([ev])
        with pytest.raises(ValueError) as want:
            jobs.validate_trace_events([ev])
        assert str(got.value) == str(want.value)


def test_flight_sink_and_telemetry_bundle(tmp_path, case):
    path = tmp_path / "flight.jsonl"
    tel = obs.Telemetry(flight_path=str(path), max_sweeps=1)
    for _ in range(2):
        msbfs_pipelined(case.wg.csr, case.roots[:4], lanes=8,
                        recorder=tel.recorder("msbfs", source="test"))
    tel.close()
    assert len(tel.sweeps) == 1 and tel.last_sweep().meta == {
        "source": "test"}
    assert "obs_sweeps_dropped_total 1" in tel.metrics_text()
    back = obs.records_from_jsonl(str(path))
    assert len(back) == 2 * tel.last_sweep().num_layers
    assert back[-tel.last_sweep().num_layers:] == tel.last_sweep().records
    assert obs.Telemetry(record_sweeps=False).recorder("msbfs") is None
    assert sorted(obs.__all__) == sorted(jobs.__all__)
