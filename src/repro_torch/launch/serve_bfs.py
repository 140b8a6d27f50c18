"""Analytics serving CLI — a thin front end over ``repro_torch.serving``
(port of ``repro.launch.serve_bfs``), on the GPU.

The serving loop itself lives in ``repro_torch.serving.AnalyticsService``:
admission control (bounded pending queue, per-tenant quotas), FIFO
dispatch into the packed MS-BFS and delta-stepping tropical lane pools,
and mid-sweep STREAMING read-outs — a depth-k ``khop`` (or ``reach``)
request is answered the moment its lane's layer counter passes k,
bit-identical to the offline ``run_query`` answer, and its lane is
retired back to the pool. This module provides:

* ``main`` — the CLI: generate an R-MAT graph, build a deterministic
  mixed-workload trace (``repro_torch.serving.trace.synthetic_trace`` —
  every request is an ``AnalyticsRequest`` envelope, so the CLI and
  ``run_query`` route through the SAME tag registry and handler table),
  replay it through the service, print the stats JSON;
* ``serve`` / ``Request`` / ``make_requests`` / ``bfs_requests`` — the
  tuple-tagged request API implemented ON TOP of the service (streaming
  off, single epoch): flush-time answers, sojourn accounting and BFS-tree
  validation.

  PYTHONPATH=src python -m repro_torch.launch.serve_bfs --scale 12 \
      --lanes 32 --queries 64 --mix bfs:4,khop:2,reach:1,closeness:1,sssp:2 \
      --burst 4 --every 2 [--validate] [--ndev 4] [--delta 0.05] \
      [--slots 256] [--tenants 2] [--tenant-quota 16] [--no-streaming] \
      [--device cpu]

``--device`` is the torch device of the graph and the engines: the GPU
unless given (it raises without one); ``--device cpu`` takes the kernels'
plain PyTorch versions. ``--ndev N`` (N > 1) shards both lane pools over
N ranks: the graph is built once, handed to the ranks by file, and
``distributed.ranks.run_ranks`` starts one process a rank (NCCL, one GPU
a rank: N must not exceed the card count; gloo ranks with ``--device
cpu``). Rank 0 is the service's front door: it replays the trace (or runs
the live path, with the HTTP plane, flight log, doctor and trace files on
rank 0 only) while the other ranks follow (``AnalyticsService.follow``).

``--listen PORT`` switches to the LIVE path: the service runs its worker
thread, an ``ObservabilityServer`` exposes /metrics, /healthz, /readyz,
/debug/* and the /v1 submit/poll/result wire transport, the synthetic
trace is submitted through the real front door, and the process stays up
``--serve-seconds`` for external scrapes. ``--flight-out`` streams the
per-layer flight log (JSONL), ``--doctor-out`` writes the sweep-doctor
audit of the recorded sweeps (see ``repro_torch.obs.doctor``), and
``--slo-p99`` / ``--slo-queue-depth`` / ``--slo-reject-rate`` arm the SLO
watchdog behind /readyz.

Latency is measured in engine *layers* (the deterministic unit of work);
aggregate TEPS counts the packed engine's traversed edges only (weighted
relaxation work is reported as ``sssp_steps``).
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field

import numpy as np

from repro_torch.analytics.api import (AnalyticsRequest, BFSQuery,
                                       ClosenessQuery, KHopQuery, ReachQuery,
                                       SSSPQuery)
from repro_torch.analytics.api import QUERY_KINDS as _API_KINDS
from repro_torch.core.csr import WeightedCSRGraph
from repro_torch.graph.generator import rmat_weighted_graph, sample_roots
from repro_torch.serving import AnalyticsService, ServiceConfig
from repro_torch.serving.trace import parse_mix, synthetic_trace

# the streamable subset of the query registry this harness's compat
# surface understands (whole-graph kinds go through the service's inline
# batch path and have no tuple-tagged Request spelling)
QUERY_KINDS = ("bfs", "khop", "reach", "closeness", "sssp")
assert set(QUERY_KINDS) <= set(_API_KINDS)


@dataclass
class Request:
    """One tagged serving request = 1+ BFS lanes through the shared engine."""
    qtype: str                   # one of QUERY_KINDS
    roots: np.ndarray            # int32[s] lanes this request enqueues
    k: int = 0                   # khop radius
    target: int = -1             # reach target vertex
    slots: slice | None = None   # engine queue slots, set at enqueue time
    answer: dict = field(default_factory=dict)


def bfs_requests(roots) -> list[Request]:
    """Plain BFS workload: one request per root."""
    return [Request("bfs", np.asarray([r], np.int32)) for r in roots]


def make_requests(g, num: int, mix: str = "bfs", seed: int = 0,
                  khop_k: int = 2, closeness_sources: int = 8,
                  ) -> list[Request]:
    """Draw ``num`` requests from the workload mix (tags validated by
    ``serving.trace.parse_mix`` — the ONE registry-backed error
    path). Roots follow the Graph500 sampling rule (degree > 0); reach
    targets are arbitrary vertices (unreachable answers are part of the
    workload)."""
    weights = parse_mix(mix)
    bad = sorted(set(weights) - set(QUERY_KINDS))
    if bad:
        raise ValueError(
            f"mix {mix!r} includes non-streamable tags {bad} — the "
            f"tuple-tagged request surface serves {QUERY_KINDS}; submit "
            f"those kinds to AnalyticsService as envelopes instead")
    rng = np.random.default_rng(seed)
    kinds = rng.choice(list(weights), size=num, p=list(weights.values()))
    # a degree>0 pool for traversal roots; requests may reuse roots (they
    # are independent traversals). Closeness sources are NOT drawn from
    # the pool: the closeness_from_depths n/k scaling assumes sources
    # uniform over ALL n vertices (zero-degree ones included), exactly
    # like the offline estimator — a deg>0 pool would inflate the
    # estimates by ~n/pool.size.
    pool = sample_roots(g, g.n, seed=seed + 1)
    closeness_sources = min(max(1, closeness_sources), g.n)
    out = []
    for kind in kinds:
        if kind == "closeness":
            s = np.sort(rng.choice(g.n, size=closeness_sources,
                                   replace=False)).astype(np.int32)
            out.append(Request("closeness", s))
        elif kind == "sssp":
            out.append(Request(
                "sssp", np.asarray([rng.choice(pool)], np.int32)))
        elif kind == "reach":
            out.append(Request(
                "reach", np.asarray([rng.choice(pool)], np.int32),
                target=int(rng.integers(g.n))))
        elif kind == "khop":
            out.append(Request(
                "khop", np.asarray([rng.choice(pool)], np.int32), k=khop_k))
        else:
            out.append(Request(
                "bfs", np.asarray([rng.choice(pool)], np.int32)))
    return out


def _to_envelope(req: Request, arrival: int) -> AnalyticsRequest:
    """Lift a tuple-tagged compat request into the unified envelope —
    explicit sources everywhere, so the service's answers reproduce the
    old loop's references bit-for-bit."""
    roots = tuple(int(r) for r in req.roots)
    if req.qtype == "bfs":
        q = BFSQuery(sources=roots)
    elif req.qtype == "khop":
        q = KHopQuery(sources=roots, k=int(req.k))
    elif req.qtype == "reach":
        q = ReachQuery(sources=roots, targets=(int(req.target),))
    elif req.qtype == "closeness":
        q = ClosenessQuery(sources=roots, chunk=len(roots))
    elif req.qtype == "sssp":
        q = SSSPQuery(sources=roots)   # delta pinned at the service level
    else:
        raise ValueError(
            f"unknown query type {req.qtype!r} — expected {QUERY_KINDS}")
    return AnalyticsRequest(query=q, arrival=int(arrival))


def _compat_answer(req: Request, result) -> dict:
    """The old loop's per-request answer dict from the typed result."""
    if req.qtype == "bfs":
        d = np.asarray(result.depth)[:, 0]
        return dict(reached=int((d >= 0).sum()), layers=int(d.max()) + 1)
    if req.qtype == "khop":
        return dict(k=req.k, size=int(result.counts[0]))
    if req.qtype == "reach":
        hops = int(result.hops[0, 0])
        return dict(target=req.target, hops=hops, reachable=hops >= 0)
    if req.qtype == "closeness":
        c = result.closeness
        v = int(np.argmax(c))
        return dict(sources=int(req.roots.size), top_vertex=v,
                    top_closeness=float(c[v]))
    d = np.asarray(result.dist)[:, 0]
    fin = np.isfinite(d)
    return dict(reached=int(fin.sum()),
                max_dist=float(d[fin].max()) if fin.any() else 0.0,
                truncated=bool(result.truncated_lanes.any()))


def _answers_summary(requests: list[Request]) -> dict:
    """Per-type answer summary (the old stats['answers'] block)."""
    summary: dict[str, dict] = {}
    summary["bfs"] = dict(mean_reached=float(np.mean(
        [r.answer["reached"] for r in requests if r.qtype == "bfs"] or [0])))
    summary["khop"] = dict(mean_size=float(np.mean(
        [r.answer["size"] for r in requests if r.qtype == "khop"] or [0])))
    reach = [r for r in requests if r.qtype == "reach"]
    summary["reach"] = dict(reachable_frac=float(np.mean(
        [r.answer["reachable"] for r in reach])) if reach else 0.0)
    clo = [r for r in requests if r.qtype == "closeness"]
    summary["closeness"] = dict(top_vertices=sorted(
        {r.answer["top_vertex"] for r in clo}))
    summary["sssp"] = dict(mean_reached=float(np.mean(
        [r.answer["reached"] for r in requests if r.qtype == "sssp"] or [0])))
    return {k: v for k, v in summary.items()
            if any(r.qtype == k for r in requests)}


def serve(g, requests: list[Request], lanes: int, burst: int, every: int,
          mode: str = "hybrid", probe_impl: str = "xla",
          validate: bool = False, ndev: int = 1,
          delta: float | None = None, mesh=None) -> dict | None:
    """Feed tagged ``requests`` to the engines ``burst`` requests at a
    time every ``every`` layers; run until all are answered. Returns
    serving statistics with per-query-type sojourn breakdowns.

    This is the compatibility surface over ``AnalyticsService``: one
    epoch sized to the exact lane demand, streaming OFF (every answer at
    lane flush — the validator needs complete depth columns and BFS-tree
    parents), ``lanes=0`` adaptive pool sizing, ``delta=None`` the
    weighted default, ``ndev > 1`` (or a 1-D ``mesh``, even of one rank)
    sharding both pools. A sharded ``serve`` is called by every rank of
    the mesh: rank 0 returns the stats, the other ranks follow the
    service and return None. The BFS trees are validated on the host, a
    few lanes at a time in threads (numpy's passes over the m edge slots
    release the GIL)."""
    wg = g if isinstance(g, WeightedCSRGraph) else None
    num_req = len(requests)
    if num_req < 1:
        raise ValueError("need at least one request")
    if burst < 1 or every < 1:
        raise ValueError(f"burst and every must be >= 1, "
                         f"got burst={burst} every={every}")
    for r in requests:
        if r.qtype not in QUERY_KINDS:
            raise ValueError(
                f"unknown query type {r.qtype!r} — expected {QUERY_KINDS}")
    sssp_reqs = [r for r in requests if r.qtype == "sssp"]
    if sssp_reqs and wg is None:
        raise ValueError("sssp requests need a WeightedCSRGraph — "
                         "generate the serving graph with "
                         "rmat_weighted_graph")
    bool_cap = int(sum(r.roots.size for r in requests
                       if r.qtype != "sssp"))
    sssp_cap = int(sum(r.roots.size for r in sssp_reqs))
    if not lanes:
        from repro_torch.core.packed import adaptive_lane_pool
        base = wg.csr if wg is not None else g
        lanes = adaptive_lane_pool(max(bool_cap, 1), base.n, base.m)
    from repro_torch.traversal.sssp import DEFAULT_LANES
    svc = AnalyticsService(g, ServiceConfig(
        lanes=int(lanes), slots=max(bool_cap, 1),
        sssp_lanes=max(1, min(lanes, max(sssp_cap, 1), DEFAULT_LANES)),
        sssp_slots=max(sssp_cap, 1),
        max_pending=num_req + 1, mode=mode, probe_impl=probe_impl,
        ndev=ndev, delta=delta, streaming=False, mesh=mesh))
    return svc.lead(lambda svc: _serve_compat(svc, requests, lanes, burst,
                                              every, validate, bool_cap,
                                              sssp_cap))


def _serve_compat(svc, requests, lanes, burst, every, validate, bool_cap,
                  sssp_cap) -> dict:
    """``serve``'s front-door half: replay, answers, validation, stats."""
    num_req = len(requests)
    svc.warmup(packed=bool_cap > 0, tropical=sssp_cap > 0)

    pairs = [(req, _to_envelope(req, (i // burst) * every))
             for i, req in enumerate(requests)]
    svc.replay([env for _, env in pairs])

    for req, env in pairs:
        rec = svc.record(env.id)
        req.slots = rec.slots
        req.answer = _compat_answer(req, rec.answer.result)

    if validate and bool_cap:
        import os
        from concurrent.futures import ThreadPoolExecutor

        from repro_torch.core.csr import to_numpy_adj
        from repro_torch.graph.validate import validate_bfs_tree
        out = svc.packed_result(derive_parents=True)
        rp, ci = to_numpy_adj(svc.engine.g)
        parent = out.parent.cpu().numpy()
        # every boolean lane is a BFS tree, whatever the tag; tropical
        # lanes carry none
        trees = [(req.slots.start + j, int(r)) for req in requests
                 if req.qtype != "sssp" for j, r in enumerate(req.roots)]
        with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
            list(pool.map(lambda tree: validate_bfs_tree(
                rp, ci, parent[:, tree[0]], tree[1]), trees))

    s = svc.stats()
    stats = dict(
        requests=num_req, total_lanes=bool_cap + sssp_cap,
        lanes=int(lanes), ndev=svc.ndev, layers=s["layers"],
        wall_s=s["wall_s"], sojourn_layers=s["sojourn_layers"],
        per_type=s["per_type"],
        answers=_answers_summary(requests),
        mean_lane_occupancy=s["mean_lane_occupancy"],
        aggregate_mteps=s["aggregate_mteps"],
        validated=bool(validate and bool_cap),
    )
    if sssp_cap:
        stats["delta"] = float(svc.delta)
        stats["sssp_steps"] = s["sssp_steps"]
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--lanes", type=int, default=32,
                    help="bit-lane pool size; 0 = adaptive from queue "
                         "depth + degree stats")
    ap.add_argument("--ndev", type=int, default=1,
                    help="shard the engine over this many ranks (one GPU a "
                         "rank; gloo ranks with --device cpu)")
    ap.add_argument("--queries", type=int, default=64,
                    help="number of requests (a closeness request costs "
                         "--closeness-sources lanes)")
    ap.add_argument("--mix", default="bfs",
                    help="workload mix, e.g. bfs:4,khop:2,reach:1,"
                         "closeness:1,sssp:1 (weights optional; any tag "
                         "from the analytics registry)")
    ap.add_argument("--delta", type=float, default=None,
                    help="delta-stepping bucket width for sssp requests "
                         "(default: the graph's default_delta)")
    ap.add_argument("--khop-k", type=int, default=2)
    ap.add_argument("--closeness-sources", type=int, default=8,
                    help="sampled sources (lanes) per closeness request")
    ap.add_argument("--burst", type=int, default=8,
                    help="requests arriving per burst")
    ap.add_argument("--every", type=int, default=2,
                    help="layers between arrival bursts")
    ap.add_argument("--slots", type=int, default=256,
                    help="packed queue slots per epoch")
    ap.add_argument("--sssp-slots", type=int, default=64,
                    help="tropical queue slots per epoch")
    ap.add_argument("--max-pending", type=int, default=1024,
                    help="admission bound on the pending queue")
    ap.add_argument("--tenant-quota", type=int, default=None,
                    help="per-tenant in-flight request cap")
    ap.add_argument("--tenants", type=int, default=1,
                    help="synthetic tenants, assigned round-robin")
    ap.add_argument("--no-streaming", action="store_true",
                    help="disable mid-sweep read-outs (answer at flush)")
    ap.add_argument("--mode", default="hybrid",
                    choices=("hybrid", "topdown", "bottomup"))
    ap.add_argument("--probe-impl", default="xla", choices=("xla", "pallas"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validate", action="store_true",
                    help="validate BFS trees (forces the flush-time "
                         "compat path: one exact-capacity epoch)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the service's Prometheus text exposition "
                         "here after the run")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace JSON of "
                         "request lifecycles + per-layer sweep records "
                         "here after the run (enables sweep recording)")
    ap.add_argument("--listen", type=int, default=None, metavar="PORT",
                    help="serve the live observability/wire HTTP plane "
                         "on this port (0 = auto-assign); the synthetic "
                         "trace goes through the real submit/result "
                         "front door and the process stays up "
                         "--serve-seconds for external scrapes")
    ap.add_argument("--serve-seconds", type=float, default=0.0,
                    help="keep the HTTP plane up this long after the "
                         "trace drains (Ctrl-C exits early)")
    ap.add_argument("--flight-out", default=None, metavar="PATH",
                    help="stream the per-layer JSONL flight log here "
                         "(enables sweep recording)")
    ap.add_argument("--doctor-out", default=None, metavar="PATH",
                    help="write the sweep-doctor audit of the recorded "
                         "sweeps here (enables sweep recording)")
    ap.add_argument("--slo-p99", type=float, default=None,
                    help="SLO: p99 submit-to-answer sojourn (layers)")
    ap.add_argument("--slo-queue-depth", type=int, default=None,
                    help="SLO: max pending-queue depth")
    ap.add_argument("--slo-reject-rate", type=float, default=None,
                    help="SLO: max reject rate over the rolling window")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one)")
    args = ap.parse_args(argv)
    if args.validate and (args.metrics_out or args.trace_out
                          or args.listen is not None or args.flight_out
                          or args.doctor_out):
        ap.error("--metrics-out/--trace-out/--listen/--flight-out/"
                 "--doctor-out ride the service path — drop --validate "
                 "(the compat path has no telemetry)")

    # weights always ride along: the CSR is bit-identical to rmat_graph's,
    # boolean-only mixes simply never read them
    if args.ndev > 1:
        return _serve_ranks(args)
    g = rmat_weighted_graph(args.scale, args.edgefactor, args.seed,
                            device=args.device)
    return _serve_graph(g, args)


def _serve_ranks(args) -> dict | None:
    """``--ndev N``: the graph built once here, saved, and served by N
    ranks (``serve_rank``). Returns rank 0's stats."""
    import os
    import tempfile

    import torch

    from repro_torch.distributed.ranks import run_ranks, save_graph
    g = rmat_weighted_graph(args.scale, args.edgefactor, args.seed,
                            device=args.device)
    on_cpu = g.device.type == "cpu"
    with tempfile.TemporaryDirectory(prefix="serve_bfs_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(g, path)
        del g
        if not on_cpu:
            torch.cuda.empty_cache()    # the ranks need the card's memory
        return run_ranks(serve_rank, args.ndev, path, args,
                         device="cpu" if on_cpu else None)


def serve_rank(graph_path, args) -> dict | None:
    """One rank of ``--ndev N``: the graph from ``graph_path`` on this
    rank's device, then the CLI's path on the sharded service (rank 0 the
    front door, the others following). Returns rank 0's stats."""
    from repro_torch.distributed.ranks import load_graph, rank_device
    return _serve_graph(load_graph(graph_path, rank_device(args.device)),
                        args)


def _serve_graph(g, args) -> dict | None:
    """The CLI's path on a built graph: the compat surface with
    ``--validate``, else the replay or the live path. Only the front door
    (rank 0 of a sharded service) records, writes files and prints."""
    front = args.ndev <= 1
    if not front:
        import torch.distributed as dist
        front = dist.get_rank() == 0
    telemetry = None
    record = bool(args.trace_out or args.flight_out or args.doctor_out
                  or args.listen is not None)
    if front and (record or args.metrics_out):
        from repro_torch.obs import Telemetry
        telemetry = Telemetry(record_sweeps=record,
                              flight_path=args.flight_out)
    slo = None
    if front and (args.slo_p99 is not None or args.slo_queue_depth is not None
            or args.slo_reject_rate is not None):
        from repro_torch.obs import SLOConfig
        slo = SLOConfig(p99_sojourn_layers=args.slo_p99,
                        max_queue_depth=args.slo_queue_depth,
                        max_reject_rate=args.slo_reject_rate)
    if args.validate:
        requests = make_requests(g, args.queries, mix=args.mix,
                                 seed=args.seed, khop_k=args.khop_k,
                                 closeness_sources=args.closeness_sources)
        stats = serve(g, requests, args.lanes, args.burst, args.every,
                      mode=args.mode, probe_impl=args.probe_impl,
                      validate=True, ndev=args.ndev, delta=args.delta)
        if front:
            print(json.dumps(stats, indent=2))
        return stats
    weights = parse_mix(args.mix)
    trace = synthetic_trace(
        g.n, args.queries, mix=args.mix, seed=args.seed,
        khop_k=args.khop_k, closeness_sources=args.closeness_sources,
        burst=args.burst, every=args.every,
        tenants=tuple(f"tenant{i}" for i in range(max(args.tenants, 1))))
    svc = AnalyticsService(g, ServiceConfig(
        lanes=args.lanes, slots=args.slots, sssp_slots=args.sssp_slots,
        max_pending=args.max_pending, tenant_quota=args.tenant_quota,
        mode=args.mode, probe_impl=args.probe_impl, ndev=args.ndev,
        delta=args.delta, streaming=not args.no_streaming,
        telemetry=telemetry, slo=slo))

    def drive(svc):
        svc.warmup(tropical="sssp" in weights)
        if args.listen is not None:
            return _serve_live(svc, trace, args)
        stats = svc.replay(trace)
        _write_outputs(svc, telemetry, args, stats)
        print(json.dumps(stats, indent=2))
        return stats

    stats = svc.lead(drive)
    if telemetry is not None:
        telemetry.close()
    return stats


def _write_outputs(svc, telemetry, args, stats) -> None:
    """Post-run artifacts shared by the replay and live paths."""
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(svc.metrics_text())
        stats["metrics_out"] = args.metrics_out
    if args.trace_out:
        from repro_torch.obs import write_chrome_trace
        write_chrome_trace(args.trace_out, svc.trace_events())
        stats["trace_out"] = args.trace_out
    if args.doctor_out:
        from repro_torch.obs.doctor import diagnose
        reports = [diagnose(rec.records, n=svc.engine.n,
                            alpha=svc.config.alpha, beta=svc.config.beta,
                            mode=svc.config.mode,
                            registry=svc._registry)
                   for rec in telemetry.sweeps if rec.records]
        anomalies = sum(len(r.findings) for r in reports)
        with open(args.doctor_out, "w") as f:
            f.write("\n".join(r.text() for r in reports) + "\n")
        stats["doctor_out"] = args.doctor_out
        stats["doctor_anomalies"] = anomalies
    if args.flight_out:
        stats["flight_out"] = args.flight_out


def _serve_live(svc, trace, args) -> dict:
    """The ``--listen`` path: worker thread + HTTP plane, the synthetic
    trace submitted through the REAL front door, artifacts written as
    soon as the trace drains (so an external watcher may kill the
    process any time after the 'trace drained' line), then the server
    held open ``--serve-seconds`` for external scrapes."""
    import time

    from repro_torch.obs import ObservabilityServer

    svc.start()
    with ObservabilityServer(svc, port=args.listen) as obs:
        # the readiness marker external drivers wait for
        print(f"listening on {obs.url}", flush=True)
        for env in sorted(trace, key=lambda r: r.arrival):
            svc.submit(env)
        from repro_torch.serving.admission import REJECTED
        for env in trace:
            if svc.record(env.id).status != REJECTED:
                svc.result(env.id, timeout=600.0)
        stats = svc.stats()
        _write_outputs(svc, svc.telemetry, args, stats)
        print(json.dumps(stats, indent=2), flush=True)
        print("trace drained; serving until deadline", flush=True)
        deadline = time.monotonic() + max(args.serve_seconds, 0.0)
        try:
            while time.monotonic() < deadline:
                time.sleep(0.2)
                health = svc.health()
                if "error" in health:
                    raise RuntimeError(
                        f"service worker failed: {health['error']}")
        except KeyboardInterrupt:
            pass
    svc.stop()
    return stats


if __name__ == "__main__":
    main()
