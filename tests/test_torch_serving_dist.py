"""The port's sharded service pools behind one front door over the ranks
(``AnalyticsService(ndev=, mesh=)``, ``serving.frontdoor``,
``serve_bfs --ndev``, ``serve_bench --ndev``) against ``repro.serving``.

Scenarios, each replayed by the reference's sharded service at ndev 1
(its host service), 2 and 4 in one child with four forced host devices,
and by the port on four gloo ranks (``run_ranks``) over the whole 4-rank
mesh, a 2-rank sub-mesh and a 1-rank mesh (the sharded pools on one rank),
with rank 0 the front door and the other ranks following; rank 0 also
replays the port's host service:

* the reference's ``test_serving_dist_streaming_parity`` (a path graph of
  96 vertices, ``slots=4``, a khop and a reach, streaming on and flush);
* a mixed replay on a scale-8 weighted R-MAT (the serve mix, bursts of 4
  every 2 layers, two tenants) with a ``ComponentsQuery`` and an
  ``SSSPQuery`` of a foreign delta, which take the inline batch path on
  the ranks.

Every ``RequestRecord`` field, every answer's wire JSON and ``stats()``
(the host clock aside) equal the reference's at the same ndev and the
port's host service (the answers' ``ndev`` aside). Two more launches of two
ranks run the entry points (``serve(validate=True, ndev=2)``,
``serve_bench.bench_points(ndev=2)`` against the reference's) and the live
path (the worker thread, submits from a second thread and over ``/v1``,
idle heartbeats, the followers' exit); ``serve_bfs.main(["--ndev", "2",
...])`` launches its own ranks. Two failing launches show that a rank
that raises mid-replay, and a front door whose worker dies, end
``run_ranks`` at once with the traceback. Everything starts together on
first use; exact equality throughout.
"""
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.distributed.ranks import run_ranks

RECORD_FIELDS = ("status", "reason", "engine", "slots", "submit_layer",
                 "dispatch_layer", "answer_layer", "answered_early",
                 "sojourn")
MIX = "bfs:3,khop:3,reach:2,closeness:1,sssp:2"
NDEVS = (1, 2, 4)
HEARTBEAT_S = 0.2
CLI = ["--scale", "7", "--lanes", "32", "--queries", "16", "--mix",
       "bfs:3,khop:2,reach:1,sssp:1", "--ndev", "2"]
SERVE_MIX = "bfs:3,khop:2,reach:1,closeness:1,sssp:1"
STATS_CLOCK = ("wall_s", "aggregate_mteps")

# shared by the reference children and the port's ranks: the scenarios'
# record views and traces, spelled for either package (a template: the
# children's code is formatted once, with FIELDS and MIX)
COMMON = """
import json
import numpy as np

FIELDS = {fields!r}
MIX = {mix!r}


def rec_view(svc, ids):
    out = {{}}
    for i in ids:
        r = svc.record(i)
        d = {{f: getattr(r, f) for f in FIELDS}}
        d["slots"] = None if r.slots is None else [r.slots.start,
                                                   r.slots.stop]
        d["answer"] = None if r.answer is None else json.dumps(
            r.answer.to_wire(include_result=True), sort_keys=True)
        out[i] = d
    return out


def clockless(stats):
    return {{k: v for k, v in stats.items()
            if k not in ("wall_s", "aggregate_mteps")}}


def path_requests(AnalyticsRequest, KHopQuery, ReachQuery):
    return [AnalyticsRequest(query=KHopQuery(sources=(0, 7), k=2), id="k"),
            AnalyticsRequest(query=ReachQuery(sources=(0,), targets=(5,)),
                             id="r")]


def mixed_trace(n, synthetic_trace, AnalyticsRequest, ComponentsQuery,
                SSSPQuery):
    tr = synthetic_trace(n, 24, mix=MIX, seed=1, burst=4, every=2,
                         tenants=("t0", "t1"))
    tr += [AnalyticsRequest(query=ComponentsQuery(batch=32), arrival=3),
           AnalyticsRequest(query=SSSPQuery(sources=(1, 2), delta=0.25),
                            arrival=5)]
    for i, r in enumerate(tr):
        r.id = f"m{{i}}"
    return tr
"""

REF_SCENARIOS = COMMON + """
from repro.analytics import ComponentsQuery, KHopQuery, ReachQuery, SSSPQuery
from repro.analytics.api import AnalyticsRequest
from repro.core.csr import from_edges
from repro.graph.generator import rmat_weighted_graph
from repro.serving import AnalyticsService, ServiceConfig, synthetic_trace

out = {{}}
n = 96
g = from_edges(np.arange(n - 1), np.arange(1, n), n)
for ndev in {ndevs!r}:
    for streaming in (True, False):
        svc = AnalyticsService(g, slots=4, ndev=ndev, streaming=streaming)
        for env in path_requests(AnalyticsRequest, KHopQuery, ReachQuery):
            svc.submit(env)
        svc.run_until_idle()
        out[f"path/{{ndev}}/{{streaming}}"] = dict(
            records=rec_view(svc, ["k", "r"]), stats=clockless(svc.stats()))
wg = rmat_weighted_graph(8, 8, seed=1)
for ndev in {ndevs!r}:
    tr = mixed_trace(wg.csr.n, synthetic_trace, AnalyticsRequest,
                     ComponentsQuery, SSSPQuery)
    svc = AnalyticsService(wg, ServiceConfig(slots=32, sssp_slots=8,
                                             ndev=ndev))
    stats = svc.replay(tr)
    out[f"mixed/{{ndev}}"] = dict(
        records=rec_view(svc, [r.id for r in tr]), stats=clockless(stats),
        edges=svc._packed.edges())
with open({out!r}, "w") as f:
    json.dump(out, f)
print("REF_SCENARIOS_OK")
"""

REF_ENTRY = COMMON + """
import contextlib
import importlib.util
import io
import sys

from repro.graph.generator import rmat_weighted_graph
from repro.launch import serve_bfs

out = {{}}
wg = rmat_weighted_graph(8, 8, seed=1)
reqs = serve_bfs.make_requests(wg, 16, mix={serve_mix!r}, seed=0)
out["serve"] = clockless(serve_bfs.serve(wg, reqs, 0, 4, 2, validate=True,
                                         ndev=2))
spec = importlib.util.spec_from_file_location(
    "reference_serve_bench", {bench!r})
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)
out["bench"] = bench.bench_points(8, queries=16, ndev=2)
sys.argv = ["serve_bfs"] + {cli!r}
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    serve_bfs.main()
out["main"] = clockless(json.loads(buf.getvalue()))
with open({out!r}, "w") as f:
    json.dump(out, f)
print("REF_ENTRY_OK")
"""


def _common():
    """The shared helpers, for the port's ranks."""
    ns = {}
    exec(COMMON.format(fields=RECORD_FIELDS, mix=MIX), ns)
    return ns


def scenario_rank():
    """Four ranks: both scenarios on the sharded service over the 4-rank
    mesh, a 2-rank sub-mesh (ranks 0 and 1) and a 1-rank mesh (rank 0),
    each rank 0 the front door; rank 0 also on the host service. The
    mixed replay records its sweeps on rank 0 alone (a recorder must add
    no collective). Returns rank 0's views."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.analytics import (ComponentsQuery, KHopQuery,
                                       ReachQuery, SSSPQuery)
    from repro_torch.analytics.api import AnalyticsRequest
    from repro_torch.core.csr import from_edges
    from repro_torch.core.dist_msbfs import host_mesh
    from repro_torch.graph.generator import rmat_weighted_graph
    from repro_torch.obs import Telemetry
    from repro_torch.serving import (AnalyticsService, ServiceConfig,
                                     synthetic_trace)
    c = _common()
    rank = dist.get_rank()
    grid = init_device_mesh("cpu", (2, 2), mesh_dim_names=("row", "col"))
    ones = init_device_mesh("cpu", (4, 1), mesh_dim_names=("rest", "data"))
    meshes = {4: host_mesh(4, "cpu"), 2: grid["col"], 1: ones["data"]}
    n = 96
    g = from_edges(np.arange(n - 1), np.arange(1, n), n, device="cpu")
    wg = rmat_weighted_graph(8, 8, seed=1, device="cpu")
    out = {}

    def path(svc):
        for env in c["path_requests"](AnalyticsRequest, KHopQuery,
                                      ReachQuery):
            svc.submit(env)
        svc.run_until_idle()
        return dict(records=c["rec_view"](svc, ["k", "r"]),
                    stats=c["clockless"](svc.stats()))

    def mixed(svc):
        tr = c["mixed_trace"](wg.n, synthetic_trace, AnalyticsRequest,
                              ComponentsQuery, SSSPQuery)
        svc.warmup()
        stats = svc.replay(tr)
        return dict(records=c["rec_view"](svc, [r.id for r in tr]),
                    stats=c["clockless"](stats), edges=svc._packed.edges(),
                    recorders=sorted({r.engine for r in svc.telemetry.sweeps}))

    runs = [(ndev, dict(mesh=mesh)) for ndev, mesh in meshes.items()
            if rank < ndev]
    if rank == 0:
        runs.append(("host", {}))
    for ndev, where in runs:
        for streaming in (True, False):
            svc = AnalyticsService(g, slots=4, streaming=streaming, **where)
            out[f"path/{ndev}/{streaming}"] = svc.lead(path)
        svc = AnalyticsService(wg, ServiceConfig(
            slots=32, sssp_slots=8,
            telemetry=Telemetry() if rank == 0 else None, **where))
        out[f"mixed/{ndev}"] = svc.lead(mixed)
    return out


def entry_rank():
    """Two ranks: ``serve(validate=True, ndev=2)`` and
    ``serve_bench.bench_points(ndev=2)``, then the live path of a sharded
    service: rank 0 starts the worker and an ``ObservabilityServer``,
    submits from a second thread and over ``/v1``, waits for the answers,
    idles for more than two heartbeat periods, and stops; it also replays
    the same requests on the host service. Rank 1 follows, counting the
    ops, and raises unless it saw the heartbeats and every tick. Returns
    rank 0's results."""
    import threading
    import urllib.request

    import torch.distributed as dist

    from repro_torch.analytics import BFSQuery, KHopQuery, SSSPQuery
    from repro_torch.analytics.api import AnalyticsRequest
    from repro_torch.benchmarks import serve_bench
    from repro_torch.graph.generator import rmat_weighted_graph
    from repro_torch.launch import serve_bfs
    from repro_torch.obs import ObservabilityServer
    from repro_torch.serving import AnalyticsService, ServiceConfig
    from repro_torch.serving import frontdoor as fd
    c = _common()
    rank = dist.get_rank()
    out = {}
    wg = rmat_weighted_graph(8, 8, seed=1, device="cpu")
    reqs = serve_bfs.make_requests(wg, 16, mix=SERVE_MIX, seed=0)
    stats = serve_bfs.serve(wg, reqs, 0, 4, 2, validate=True, ndev=2)
    out["serve"] = stats and c["clockless"](stats)
    out["bench"] = serve_bench.bench_points(8, queries=16, ndev=2,
                                            device="cpu")

    def envs():
        return [AnalyticsRequest(query=q, id=f"live{i}")
                for i, q in enumerate((
                    KHopQuery(sources=(1, 2), k=2), BFSQuery(sources=(3,)),
                    SSSPQuery(sources=(4,)), KHopQuery(sources=(5,), k=1),
                    BFSQuery(sources=(6, 7))))]

    fd.HEARTBEAT_S = HEARTBEAT_S
    cfg = dict(slots=32, sssp_slots=8, streaming=False)
    svc = AnalyticsService(wg, ServiceConfig(ndev=2, **cfg))
    if rank != 0:
        ops = []
        recv = svc._channel.recv

        def counted():
            op = recv()
            ops.append(op[0])
            return op
        svc._channel.recv = counted
        svc.follow()
        beats = ops.count(fd.HEARTBEAT)
        if beats < 2 or ops.count(fd.STEP) != svc._layer:
            raise AssertionError(f"follower ops {ops}, layer {svc._layer}")
        return None

    def live(svc):
        batch = envs()
        svc.start()
        with ObservabilityServer(svc, port=0) as obs:
            th = threading.Thread(
                target=lambda: [svc.submit(e) for e in batch[:3]])
            th.start()
            th.join()
            for env in batch[3:]:
                req = urllib.request.Request(
                    obs.url + "/v1/submit",
                    data=json.dumps(env.to_wire()).encode(),
                    headers={"Content-Type": "application/json"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=60) as r:
                    assert json.loads(r.read())["status"] == "QUEUED"
            got = {e.id: svc.result(e.id, timeout=120) for e in batch}
            layer = svc._layer
            time.sleep(3.5 * HEARTBEAT_S)
            idle_layers = svc._layer - layer
            alive = svc.worker_alive()
        svc.stop()
        return dict(answers={i: json.dumps(a.to_wire(include_result=True),
                                           sort_keys=True)
                             for i, a in got.items()},
                    idle_layers=idle_layers, alive=alive)

    out["live"] = svc.lead(live)
    host = AnalyticsService(wg, ServiceConfig(**cfg))
    host.replay(envs())
    out["live_host"] = c["rec_view"](host, [e.id for e in envs()])
    return out


def follower_fails_rank():
    """Two ranks on the path graph; rank 1's packed engine raises on its
    third step, in the middle of the replay."""
    import torch.distributed as dist

    from repro_torch.analytics import BFSQuery, KHopQuery
    from repro_torch.core.csr import from_edges
    from repro_torch.serving import AnalyticsService
    n = 96
    g = from_edges(np.arange(n - 1), np.arange(1, n), n, device="cpu")
    svc = AnalyticsService(g, slots=4, ndev=2)
    if dist.get_rank() == 1:
        pool = svc._pool("packed")
        step, calls = pool._step, []

        def failing(state):
            calls.append(1)
            if len(calls) == 3:
                raise RuntimeError("injected follower failure")
            return step(state)
        pool._step = failing

    def drive(svc):
        svc.submit(KHopQuery(sources=(0,), k=50))
        svc.submit(BFSQuery(sources=(3,)))
        return svc.run_until_idle()
    return svc.lead(drive)


def worker_dies_rank(marker):
    """Two ranks on the path graph; rank 0's worker dies after a tick's
    collectives (its SLO monitor, which rank 0 alone runs, raises). Rank
    1, waiting for its next op, must get the error op with rank 0's
    traceback; it writes ``marker`` and raises it, while rank 0's
    ``result()`` raises once rank 1 has."""
    import torch.distributed as dist

    from repro_torch.analytics import KHopQuery
    from repro_torch.core.csr import from_edges
    from repro_torch.obs import SLOConfig
    from repro_torch.serving import AnalyticsService
    n = 96
    g = from_edges(np.arange(n - 1), np.arange(1, n), n, device="cpu")
    front = dist.get_rank() == 0
    svc = AnalyticsService(g, slots=4, ndev=2, slo=(
        SLOConfig(max_queue_depth=8) if front else None))
    if not front:
        try:
            svc.follow()
        except RuntimeError as e:
            if "front door" in str(e) and "injected worker failure" in str(e):
                with open(marker, "w") as f:
                    f.write(str(e))
            raise
        return None

    def evaluate():
        raise RuntimeError("injected worker failure")

    def drive(svc):
        svc.slo.evaluate = evaluate
        svc.start()
        rec = svc.submit(KHopQuery(sources=(0,), k=2))
        try:
            svc.result(rec.request.id, timeout=60)
        finally:
            deadline = time.monotonic() + 20
            while not os.path.exists(marker) and time.monotonic() < deadline:
                time.sleep(0.05)
    return svc.lead(drive)


def timed_launch(fn, *args):
    """(seconds, result or the exception) of one 2-rank launch."""
    t0 = time.monotonic()
    try:
        out = run_ranks(fn, 2, *args, device="cpu")
    except Exception as e:          # noqa: BLE001 — the tests read it
        out = e
    return time.monotonic() - t0, out


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The in-process replays on a few torch threads, beside the ranks and
    the reference children (restored after the module)."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every launch of the module, started together on first use."""
    from repro_torch.launch import serve_bfs
    tmp = tmp_path_factory.mktemp("serving_dist")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pool = ThreadPoolExecutor(7)
    jobs = {}
    for name, code in (("scenarios", REF_SCENARIOS), ("entry", REF_ENTRY)):
        path = str(tmp / f"ref_{name}.json")
        src = code.format(fields=RECORD_FIELDS, mix=MIX, ndevs=NDEVS,
                          out=path, serve_mix=SERVE_MIX,
                          cli=CLI, bench=os.path.join(
                              repo, "benchmarks", "serve_bench.py"))
        jobs["ref", name] = (pool.submit(run_in_subprocess, src,
                                         devices=4), path)
    jobs["scenarios"] = pool.submit(run_ranks, scenario_rank, 4,
                                    device="cpu")
    jobs["entry"] = pool.submit(run_ranks, entry_rank, 2, device="cpu")
    jobs["main"] = pool.submit(serve_bfs.main, CLI + ["--device", "cpu"])
    jobs["follower_fails"] = pool.submit(timed_launch, follower_fails_rank)
    marker = str(tmp / "follower_got_error")
    jobs["worker_dies"] = (pool.submit(timed_launch, worker_dies_rank,
                                       marker), marker)
    yield jobs
    pool.shutdown()


def reference(jobs, name) -> dict:
    future, path = jobs["ref", name]
    assert f"REF_{name.upper()}_OK" in future.result()
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ref_scenarios(jobs):
    return reference(jobs, "scenarios")


@pytest.fixture(scope="module")
def ref_entry(jobs):
    return reference(jobs, "entry")


@pytest.fixture(scope="module")
def port(jobs):
    return jobs["scenarios"].result()


@pytest.fixture(scope="module")
def entry(jobs):
    return jobs["entry"].result()


def without_ndev(obj):
    """A JSON value with every ``ndev`` entry dropped."""
    if isinstance(obj, dict):
        return {k: without_ndev(v) for k, v in obj.items() if k != "ndev"}
    if isinstance(obj, list):
        return [without_ndev(v) for v in obj]
    return obj


def host_view(view: dict) -> dict:
    """A scenario's records and stats with the partition taken out, for
    the comparison with the host service."""
    out = json.loads(json.dumps(view))
    for rec in out["records"].values():
        if rec["answer"] is not None:
            rec["answer"] = without_ndev(json.loads(rec["answer"]))
    out["stats"] = without_ndev(out["stats"])
    return out


def assert_view(got: dict, want: dict, what):
    got = json.loads(json.dumps(got))       # tuples and ints as JSON has them
    assert got["records"].keys() == want["records"].keys(), what
    for rid, rec in want["records"].items():
        for f, v in rec.items():
            assert got["records"][rid][f] == v, (what, rid, f)
    assert got["stats"] == want["stats"], what
    assert got.get("edges") == want.get("edges"), what


@pytest.mark.parametrize("streaming", [True, False])
@pytest.mark.parametrize("ndev", NDEVS)
def test_streaming_scenario_matches_reference_and_host(port, ref_scenarios,
                                                       ndev, streaming):
    got = port[f"path/{ndev}/{streaming}"]
    assert_view(got, ref_scenarios[f"path/{ndev}/{streaming}"], "reference")
    assert_view(host_view(got), host_view(port[f"path/host/{streaming}"]),
                "host")
    k = json.loads(got["records"]["k"]["answer"])
    assert k["meta"]["ndev"] == ndev and got["stats"]["ndev"] == ndev
    early = [got["records"][i]["answered_early"] for i in ("k", "r")]
    assert early == [streaming, streaming]
    if streaming:       # the flush twin answers the khop later
        flush = port[f"path/{ndev}/False"]["records"]["k"]["sojourn"]
        assert flush - got["records"]["k"]["sojourn"] >= 1


@pytest.mark.parametrize("ndev", NDEVS)
def test_mixed_replay_matches_reference_and_host(port, ref_scenarios, ndev):
    got = port[f"mixed/{ndev}"]
    want = ref_scenarios[f"mixed/{ndev}"]
    assert_view(got, want, "reference")
    assert_view(host_view(got), host_view(port["mixed/host"]), "host")
    engines = {r["engine"] for r in got["records"].values()}
    assert engines == {"packed", "tropical", "batch"}
    # the pools' and the inline sweeps' recorders, on rank 0 alone
    assert got["recorders"] == ["dist_msbfs", "dist_sssp"]
    assert port["mixed/host"]["recorders"] == ["msbfs", "sssp"]
    assert got["stats"]["delta"] == want["stats"]["delta"] is not None


def test_entry_points_match_reference(entry, ref_entry):
    assert entry["serve"] == ref_entry["serve"] and entry["serve"]["validated"]
    assert entry["serve"]["ndev"] == 2
    got, want = entry["bench"], ref_entry["bench"]
    assert list(got) == list(want)
    for name in got:
        if not name.startswith("mix_teps"):
            assert got[name] == want[name], name


def test_cli_ndev_matches_reference(jobs, ref_entry):
    got = {k: v for k, v in jobs["main"].result().items()
           if k not in STATS_CLOCK}
    assert got == ref_entry["main"] and got["ndev"] == 2


def test_live_path_answers_and_heartbeats(entry):
    """The live answers equal the synchronous host replay's (the partition
    aside); idling ticked no layer; rank 1 saw the heartbeats and every
    tick, and exited (its checks raise otherwise)."""
    live = entry["live"]
    assert live["idle_layers"] == 0 and live["alive"]
    for rid, rec in entry["live_host"].items():
        assert without_ndev(json.loads(live["answers"][rid])) == \
            without_ndev(json.loads(rec["answer"])), rid


def test_follower_failure_ends_the_launch(jobs):
    seconds, out = jobs["follower_fails"].result()
    assert isinstance(out, RuntimeError), out
    assert "rank 1 of 2 failed" in str(out)
    assert "injected follower failure" in str(out)
    assert seconds < 30


def test_worker_death_reaches_followers(jobs):
    future, marker = jobs["worker_dies"]
    seconds, out = future.result()
    assert isinstance(out, RuntimeError), out
    assert "injected worker failure" in str(out)
    with open(marker) as f:
        assert "front door (rank 0) failed" in f.read()
    assert seconds < 30


def test_entry_points_raise_without_gpu(monkeypatch):
    """``--ndev N`` runs on the GPU unless told otherwise, as ``--ndev 1``
    does; N ranks above the card count raise (``run_ranks``)."""
    from repro_torch.benchmarks import serve_bench
    from repro_torch.launch import serve_bfs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bfs.main(["--scale", "6", "--queries", "2", "--ndev", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bench.main(["--scale", "6", "--queries", "2", "--ndev", "2"])
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        run_ranks(print, 2)
