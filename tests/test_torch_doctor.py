"""The port's sweep doctor (``repro_torch.obs.doctor``) against
``repro.obs.doctor``.

The oracle ``replay_switch`` is the reference's, a float32 division, and
must decide as the reference's does. On one flight log (a JSONL stream of
``LayerRecord``s from a service replay) both doctors must write the same
reports, with the run's alpha and with a wrong one, which flags layers;
the port's own flight log of the same replay must give the same reports
too, and so must a recorded sweep, the synthetic anomaly families and the
CLI. The port runs on the CPU; the reference's replay is built once per
module.
"""
import json
from types import SimpleNamespace

import numpy as np
import pytest

from repro.graph.generator import rmat_weighted_graph as jrmat_weighted
from repro.obs import Telemetry as JTelemetry
from repro.obs import doctor as jdoctor
from repro.serving import AnalyticsService as JService
from repro.serving import synthetic_trace as jsynthetic_trace
from repro_torch.core.csr import from_numpy_weighted_graph
from repro_torch.core.hybrid import ALPHA_DEFAULT, BETA_DEFAULT
from repro_torch.core.msbfs import msbfs_pipelined
from repro_torch.obs import LayerRecord, SweepRecorder, Telemetry, doctor
from repro_torch.serving import AnalyticsService, synthetic_trace

MIX = "bfs:4,khop:2,reach:1,closeness:1,sssp:1"
N = 256          # rmat_weighted_graph(8, ...)
# an alpha far from the run's 14: the oracle disagrees with recorded layers
WRONG_ALPHA = 1.5


def reports(mod, records, **kw):
    return [r.as_dict() for r in mod.diagnose_log(records, **kw)]


def texts(mod, records, **kw):
    return [r.text() for r in mod.diagnose_log(records, **kw)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("flight")
    jwg = jrmat_weighted(8, 8, seed=5)
    wg = from_numpy_weighted_graph(
        *(np.asarray(getattr(jwg, f))
          for f in ("row_ptr", "col_idx", "src_idx", "weights")), "cpu")
    kw = dict(mix=MIX, seed=1, burst=8, every=1)
    jtrace = jsynthetic_trace(N, 40, **kw)
    trace = synthetic_trace(N, 40, **kw)
    logs = {}
    for name, svc_cls, tel_cls, g, tr in (
            ("ref", JService, JTelemetry, jwg, jtrace),
            ("port", AnalyticsService, Telemetry, wg, trace)):
        logs[name] = str(tmp / f"{name}.jsonl")
        tel = tel_cls(flight_path=logs[name])
        svc_cls(g, lanes=32, slots=64, sssp_slots=8, telemetry=tel).replay(tr)
        tel.close()
    return SimpleNamespace(wg=wg, logs=logs)


def test_replay_switch_matches_reference():
    rng = np.random.default_rng(7)
    cases = [(bool(td), int(ef), int(vf), int(eu), int(n))
             for td, ef, vf, eu, n in zip(
                 rng.integers(0, 2, 400), rng.integers(0, 10_000, 400),
                 rng.integers(0, 3_000, 400), rng.integers(0, 10_000, 400),
                 rng.integers(1, 5_000, 400))]
    # e_u / alpha exactly at e_f, and a rounding case of the division
    cases += [(True, 100, 0, 1400, 1024), (False, 0, 42, 0, 1008),
              (True, 0, 0, 0, 1), (True, 73, 5, 1022, 64)]
    for args in cases:
        for alpha, beta in ((ALPHA_DEFAULT, BETA_DEFAULT), (3.0, 7.0)):
            assert doctor.replay_switch(*args, alpha, beta) == \
                jdoctor.replay_switch(*args, alpha, beta), args


@pytest.mark.parametrize("alpha", [ALPHA_DEFAULT, WRONG_ALPHA],
                         ids=["run_alpha", "wrong_alpha"])
def test_reports_match_reference_on_one_flight_log(case, alpha):
    kw = dict(n=N, alpha=alpha, beta=BETA_DEFAULT)
    want_recs = jdoctor.records_from_jsonl(case.logs["ref"])
    got_recs = doctor.records_from_jsonl(case.logs["ref"])
    want = reports(jdoctor, want_recs, **kw)
    assert reports(doctor, got_recs, **kw) == want
    assert texts(doctor, got_recs, **kw) == texts(jdoctor, want_recs, **kw)
    # the port's own flight log of the same replay
    assert reports(doctor, doctor.records_from_jsonl(case.logs["port"]),
                   **kw) == want
    kinds = {s["engine"] for s in want}
    assert kinds == {"msbfs", "sssp"}
    flagged = sum(s["counts"].get("mis_switch", 0) for s in want)
    if alpha == WRONG_ALPHA:
        assert flagged > 0
    else:
        assert flagged == 0


def test_recorded_sweep_report_matches_reference(case):
    from repro.core.msbfs import msbfs_pipelined as jmsbfs_pipelined
    from repro.obs import SweepRecorder as JSweepRecorder
    jwg = jrmat_weighted(8, 8, seed=5)
    roots = np.arange(48, dtype=np.int32) * 5 % N
    rec, jrec = SweepRecorder(engine="msbfs"), JSweepRecorder(engine="msbfs")
    msbfs_pipelined(case.wg.csr, roots, lanes=16, recorder=rec)
    jmsbfs_pipelined(jwg.csr, roots, lanes=16, recorder=jrec)
    for alpha in (ALPHA_DEFAULT, WRONG_ALPHA):
        got = doctor.diagnose(rec.records, n=N, alpha=alpha).as_dict()
        assert got == jdoctor.diagnose(jrec.records, n=N,
                                       alpha=alpha).as_dict()
    assert doctor.diagnose(rec.records, n=N).ok()


def _record(mod, layer, *, engine="msbfs", slots=(), rows=(), dirs=(),
            vf=(), ef=(), eu=(), active=None, exch_bytes=0,
            exch_format="none"):
    active = max(1, len(slots)) if active is None else active
    return mod.LayerRecord(
        layer=layer, engine=engine, kind="bfs", mode="td",
        active_lanes=active, frontier_words=8, frontier_density=0.1,
        edges_relaxed=0, words_touched=16, exch_bytes=exch_bytes,
        exch_format=exch_format, wall_ms=0.1, slots=slots, rows=rows,
        dirs=dirs, vf=vf, ef=ef, eu=eu)


def synthetic_stream(mod):
    """A seeded mis-switch, compressed layers dearer than dense, a queue
    stall and a starved run that recovers, over two engines."""
    r = _record
    return [
        r(mod, 0, slots=(0,), rows=(0,), dirs=(1,), vf=(30,), ef=(10,),
          eu=(100,), active=8, exch_bytes=64, exch_format="dense"),
        r(mod, 1, slots=(0,), rows=(1,), dirs=(1,), vf=(60,), ef=(40,),
          eu=(80,), active=1, exch_bytes=80, exch_format="compressed"),
        r(mod, 2, active=1), r(mod, 3, active=1), r(mod, 4, active=0),
        r(mod, 5, active=8),
        r(mod, 0, engine="dist_msbfs", active=2),
        r(mod, 1, engine="dist_msbfs", exch_bytes=10,
          exch_format="compressed"),
    ]


def test_synthetic_anomalies_match_reference():
    got_stream, want_stream = synthetic_stream(doctor), synthetic_stream(
        jdoctor)
    for kw in (dict(n=100, alpha=2.0, beta=2.0), dict(mode="topdown"),
               dict(dense_bytes=70), {}):
        assert reports(doctor, got_stream, **kw) == \
            reports(jdoctor, want_stream, **kw)
    assert [len(s) for s in doctor.split_sweeps(got_stream)] == \
        [len(s) for s in jdoctor.split_sweeps(want_stream)]
    assert doctor.diagnose([]).notes == jdoctor.diagnose([]).notes


def test_doctor_cli_matches_reference(case, capsys):
    out = {}
    for name, mod in (("ref", jdoctor), ("port", doctor)):
        for args in (["--n", str(N), "--json"],
                     ["--n", str(N), "--alpha", str(WRONG_ALPHA),
                      "--fail-on-findings"]):
            code = mod.main([case.logs["ref"]] + args)
            out.setdefault(name, []).append((code, capsys.readouterr().out))
    assert out["port"] == out["ref"]
    assert out["port"][1][0] == 1 and out["port"][0][0] == 0
    assert json.loads(out["port"][0][1].rsplit("\naudited", 1)[0])
    with open(case.logs["port"]) as f:
        assert isinstance(LayerRecord(**json.loads(f.readline())),
                          LayerRecord)
