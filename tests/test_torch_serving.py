"""The port's serving layer (``repro_torch.serving``, ``obs.server``,
``launch.serve_bfs``) against ``repro.serving``.

Both services replay the same ``synthetic_trace`` on the same weighted
R-MAT graph (carried over field by field): every ``RequestRecord``'s
lifecycle fields and every answer's wire JSON must be equal, with streaming
read-outs on and off and with a tenant quota that rejects. The port runs on
the CPU through the kernels' plain versions. The reference's replays are
built once per module. Around that: the HTTP plane on loopback against a
CPU service, the worker's failure surfacing in ``health()``, the CLI's
stats against the reference CLI's, and the sharded pools' refusal outside
a process group.
"""
import json
import sys
import time
import urllib.error
import urllib.request
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

from repro.graph.generator import rmat_weighted_graph as jrmat_weighted
from repro.launch import serve_bfs as jserve_bfs
from repro.serving import AnalyticsService as JService
from repro.serving import ServiceConfig as JConfig
from repro.serving import synthetic_trace as jsynthetic_trace
from repro_torch.analytics import KHopQuery, LaneEngine, run_query
from repro_torch.analytics.api import AnalyticsAnswer, AnalyticsRequest
from repro_torch.core.csr import from_numpy_weighted_graph
from repro_torch.launch import serve_bfs
from repro_torch.obs import ObservabilityServer, Telemetry
from repro_torch.serving import (DONE, QUEUED, REJECTED, AdmissionController,
                                 AnalyticsService, ServiceConfig, parse_mix,
                                 synthetic_trace)

MIX = "bfs:4,khop:2,reach:1,closeness:1,sssp:1"
RECORD_FIELDS = ("status", "reason", "engine", "slots", "submit_layer",
                 "dispatch_layer", "answer_layer", "answered_early")
# (id, ServiceConfig overrides): streaming read-outs on and off, and a
# one-request tenant quota, which rejects part of every burst
REPLAYS = {
    "streaming": dict(streaming=True),
    "flush": dict(streaming=False),
    "quota": dict(streaming=True, tenant_quota=1),
}


def port_graph(jwg):
    return from_numpy_weighted_graph(
        *(np.asarray(getattr(jwg, f))
          for f in ("row_ptr", "col_idx", "src_idx", "weights")), "cpu")


def traces(case):
    """The reference's and the port's trace of the same arguments, with
    the same request ids (ids are drawn from a per-package counter)."""
    kw = dict(mix=MIX, seed=0, burst=4, every=2, tenants=("t0", "t1"))
    want = jsynthetic_trace(case.jwg.csr.n, 24, **kw)
    got = synthetic_trace(case.wg.n, 24, **kw)
    for i, (a, b) in enumerate(zip(want, got)):
        a.id = b.id = f"r{i}"
    return want, got


def config(**kw):
    return dict(slots=32, sssp_slots=8, **kw)


@pytest.fixture(scope="module")
def case():
    jwg = jrmat_weighted(8, 8, seed=1)
    c = SimpleNamespace(jwg=jwg, wg=port_graph(jwg), ref={})
    for name, kw in REPLAYS.items():
        jtrace, _ = traces(c)
        svc = JService(jwg, JConfig(**config(**kw)))
        c.ref[name] = (svc, svc.replay(jtrace), jtrace)
    return c


def drop_clock(stats):
    """Stats without the host-clock numbers."""
    return {k: v for k, v in stats.items()
            if k not in ("wall_s", "aggregate_mteps")}


def answer_json(rec):
    return json.dumps(rec.answer.to_wire(include_result=True),
                      sort_keys=True)


def test_trace_equals_reference(case):
    want, got = traces(case)
    assert [json.dumps(r.to_wire()) for r in got] == \
        [json.dumps(r.to_wire()) for r in want]
    assert parse_mix(MIX) == jserve_bfs.parse_mix(MIX)


@pytest.mark.parametrize("name", list(REPLAYS))
def test_replay_matches_reference(case, name):
    jsvc, jstats, jtrace = case.ref[name]
    _, trace = traces(case)
    svc = AnalyticsService(case.wg, ServiceConfig(**config(**REPLAYS[name])))
    stats = svc.replay(trace)
    assert drop_clock(stats) == drop_clock(jstats)
    assert svc._packed.edges() == jsvc._packed.edges()
    early = 0
    for want in jtrace:
        a, b = svc.record(want.id), jsvc.record(want.id)
        for f in RECORD_FIELDS:
            assert getattr(a, f) == getattr(b, f), (want.id, f)
        if b.answer is not None:
            assert answer_json(a) == answer_json(b), want.id
        early += a.answered_early
    if name == "quota":
        assert stats["rejected"] > 0
    if name == "flush":
        assert early == 0
    else:
        assert early > 0


def test_answers_match_run_query(case):
    """The service's flush-time answers against the offline ``run_query``
    on the port's own engine: the same arrays, whatever the metadata."""
    svc = AnalyticsService(case.wg, slots=16, sssp_slots=8, streaming=False)
    eng = LaneEngine(case.wg)
    _, trace = traces(case)
    svc.replay(trace[:10])
    for env in trace[:10]:
        got = svc.record(env.id).answer.result
        want = run_query(eng, env.query)
        for f in ("depth", "words", "counts", "hops", "closeness", "dist"):
            if hasattr(want, f):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f), err_msg=f)


def test_admission_controller_matches_reference():
    from repro.serving import AdmissionController as JAdmission
    got, want = AdmissionController(2, 1), JAdmission(2, 1)
    for tenant in ("a", "a", "b", "c"):
        assert got.admit(tenant) == want.admit(tenant)
    got.on_dispatch("a"), want.on_dispatch("a")
    got.on_done("a"), want.on_done("a")
    assert got.admit("a") == want.admit("a")
    assert (got.pending, got.rejected) == (want.pending, want.rejected)


def test_distributed_pools_raise(case):
    """The sharded pools run on the ranks of a process group
    (``tests/test_torch_serving_dist.py``): without one they raise and say
    how to launch, as ``LaneEngine(ndev=2)`` does; ``grid=`` is not a
    service option (the reference's service is 1-D only)."""
    with pytest.raises(RuntimeError, match="run_ranks"):
        AnalyticsService(case.wg, ndev=2)
    with pytest.raises(ValueError, match="1-D only"):
        AnalyticsService(case.wg, grid=(1, 1))


def test_worker_failure_shows_in_health(case):
    svc = AnalyticsService(case.wg, slots=4)
    svc.warmup(packed=True, tropical=False)
    boom = RuntimeError("step failed")
    with mock.patch.object(svc._pool("packed"), "_step",
                           side_effect=boom), \
            mock.patch("threading.excepthook"):
        svc.start()
        rec = svc.submit(KHopQuery(sources=(1,), k=1))
        with pytest.raises(RuntimeError, match="worker failed") as got:
            svc.result(rec.request.id, timeout=60.0)
        assert got.value.__cause__ is boom
        svc._thread.join(60.0)
    h = svc.health()
    assert not h["alive"] and not h["ready"] and "step failed" in h["error"]
    svc.stop()


def test_concurrent_submitters_lose_no_request(case):
    """More submitting threads than cores against the worker thread, with
    a short switch interval: every request is answered once, and the
    admission and metrics books balance."""
    import os
    import threading
    threads, per_thread = 2 * (os.cpu_count() or 4), 3
    svc = AnalyticsService(case.wg, slots=256, sssp_slots=8)
    ids, errors = [], []

    def submit(t):
        try:
            for i in range(per_thread):
                rec = svc.submit(AnalyticsRequest(
                    query=KHopQuery(sources=((7 * t + i) % 256,), k=1),
                    id=f"t{t}-{i}"))
                ids.append(rec.request.id)
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with svc:
            pool = [threading.Thread(target=submit, args=(t,))
                    for t in range(threads)]
            for th in pool:
                th.start()
            for th in pool:
                th.join(120)
                assert not th.is_alive()
            for rid in ids:
                svc.result(rid, timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(ids) == threads * per_thread
    assert all(svc.poll(rid) == DONE for rid in ids)
    assert svc._admission.pending == 0 and not svc.busy()
    assert f'service_requests_total{{kind="khop",status="QUEUED"}} ' \
        f'{len(ids)}' in svc.metrics_text()


# ---------------------------------------------------------------------------
# The HTTP plane on loopback (stdlib client).
# ---------------------------------------------------------------------------


def _get_json(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post_json(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_round_trip(case):
    tel = Telemetry()
    svc = AnalyticsService(case.wg, streaming=False, telemetry=tel)
    q = KHopQuery(sources=(1, 2), k=2)
    with svc, ObservabilityServer(svc) as obs:
        base = obs.url
        assert base.startswith("http://127.0.0.1:")
        code, h = _get_json(f"{base}/readyz")
        assert code == 200 and h["ready"]
        env = AnalyticsRequest(query=q, id="wire-khop", tenant="t")
        code, body = _post_json(f"{base}/v1/submit", env.to_wire())
        assert code == 200 and body["status"] == QUEUED
        deadline = time.monotonic() + 120
        while _get_json(f"{base}/v1/poll/wire-khop")[1]["status"] != DONE:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        code, wire = _get_json(f"{base}/v1/result/wire-khop")
        assert code == 200
        got = AnalyticsAnswer.from_wire(wire).result
        want = run_query(LaneEngine(case.wg), q)
        for f in ("words", "counts", "depth", "sources"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        code, sweeps = _get_json(f"{base}/debug/sweeps?full=1")
        assert code == 200 and sweeps[0]["records"]
        code, body = _get_json(f"{base}/v1/result/ghost")
        assert code == 404
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            text = r.read().decode()
        assert 'http_requests_total{path="/v1/submit",code="200"} 1' in text
    assert not svc.health()["alive"]


def test_rejected_result_is_409(case):
    svc = AnalyticsService(case.wg, max_pending=1)
    with ObservabilityServer(svc) as obs:
        for rid, expect in (("a", QUEUED), ("b", REJECTED)):
            env = AnalyticsRequest(query=KHopQuery(sources=(0,), k=1), id=rid)
            code, body = _post_json(f"{obs.url}/v1/submit", env.to_wire())
            assert code == 200 and body["status"] == expect
        assert _get_json(f"{obs.url}/v1/result/a")[0] == 202
        assert _get_json(f"{obs.url}/v1/result/b")[0] == 409


# ---------------------------------------------------------------------------
# The CLI.
# ---------------------------------------------------------------------------

CLI_ARGS = ["--scale", "7", "--edgefactor", "8", "--queries", "12",
            "--mix", "bfs:2,khop:2,reach:1,sssp:1", "--lanes", "0",
            "--slots", "32", "--sssp-slots", "8", "--burst", "4",
            "--tenants", "2", "--tenant-quota", "4"]


def test_cli_stats_match_reference(capsys):
    with mock.patch.object(sys, "argv", ["serve_bfs"] + CLI_ARGS):
        want = jserve_bfs.main()
    capsys.readouterr()
    got = serve_bfs.main(CLI_ARGS + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert drop_clock(got) == drop_clock(want) == drop_clock(printed)
    assert got["done"] + got["rejected"] == 12


def test_cli_validate_path_matches_reference(capsys):
    args = ["--scale", "7", "--edgefactor", "8", "--queries", "10",
            "--mix", "bfs:2,khop:1,closeness:1,sssp:1", "--lanes", "0",
            "--validate"]
    with mock.patch.object(sys, "argv", ["serve_bfs"] + args):
        jserve_bfs.main()
    want = json.loads(capsys.readouterr().out)
    serve_bfs.main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert drop_clock(got) == drop_clock(want) and got["validated"]
