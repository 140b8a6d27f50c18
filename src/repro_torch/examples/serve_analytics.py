"""Online analytics serving through ``repro_torch.serving
.AnalyticsService`` (port of ``examples/serve_analytics.py``).

  python -m repro_torch.examples.serve_analytics [--device cpu]

Builds a weighted Graph500 Kronecker graph and serves it three ways:

1. **async front door**: worker thread, ``submit``/``result``; a k-hop
   query streams its answer mid-sweep (depths already assigned are
   final), bit-identical to offline ``run_query``;
2. **admission control**: a per-tenant quota bounds in-flight work, so an
   over-quota submission comes back REJECTED (with the reason) instead of
   growing the queue;
3. **trace replay**: a deterministic mixed bfs/khop/reach/sssp arrival
   process on the layer clock, with per-type sojourn stats.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.analytics import BFSQuery, KHopQuery, run_query
from repro_torch.analytics.api import AnalyticsRequest
from repro_torch.device import resolve_device
from repro_torch.graph.generator import rmat_weighted_graph
from repro_torch.serving import REJECTED, AnalyticsService, synthetic_trace


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    wg = rmat_weighted_graph(10, 8, seed=0, device=dev)
    print(f"n={wg.n:,} m={wg.m:,} (scale 10, edgefactor 8)")

    # 1. async submit/result: the worker thread drives the engines --------
    with AnalyticsService(wg, slots=64, sssp_slots=16) as svc:
        rec = svc.submit(KHopQuery(sources=(3, 17), k=2))
        ans = svc.result(rec.request.id, timeout=120.0)
    print(f"khop: counts={ans.result.counts.tolist()} "
          f"streamed_early={rec.answered_early} sojourn={rec.sojourn} "
          f"layers")
    ref = run_query(wg, KHopQuery(sources=(3, 17), k=2))
    assert np.array_equal(ans.result.words, ref.words)   # bit-identical
    assert np.array_equal(ans.result.counts, ref.counts)

    # 2. admission: quota bounds each tenant's in-flight requests ---------
    svc = AnalyticsService(wg, tenant_quota=1)
    ok = svc.submit(AnalyticsRequest(query=BFSQuery(sources=(0,)),
                                     tenant="t0"))
    over = svc.submit(AnalyticsRequest(query=BFSQuery(sources=(1,)),
                                       tenant="t0"))
    print(f"quota: first={ok.status} second={over.status} ({over.reason})")
    assert over.status == REJECTED
    svc.run_until_idle()                   # DONE releases the quota
    again = svc.submit(AnalyticsRequest(query=BFSQuery(sources=(1,)),
                                        tenant="t0"))
    assert again.status != REJECTED

    # 3. replay a mixed arrival process on the layer clock ----------------
    trace = synthetic_trace(wg.n, 24, mix="bfs:3,khop:3,reach:2,sssp:2",
                            seed=1, burst=4, every=2, tenants=("t0", "t1"))
    svc = AnalyticsService(wg, slots=64, sssp_slots=16)
    stats = svc.replay(trace)
    print(f"replay: {stats['done']}/{stats['requests']} answered in "
          f"{stats['layers']} layers, "
          f"{100 * stats['answered_early_frac']:.0f}% streamed early, "
          f"sojourn p50={stats['sojourn_layers']['p50']} "
          f"p99={stats['sojourn_layers']['p99']}")
    for kind, row in sorted(stats["per_type"].items()):
        print(f"  {kind:6s} x{row['count']:<3d} "
              f"sojourn p50={row['sojourn_layers']['p50']}")

    assert stats["done"] == stats["requests"] and stats["rejected"] == 0
    assert stats["answered_early_frac"] > 0   # khop/reach streamed mid-sweep
    print("serving OK")
    return dict(khop_counts=ans.result.counts.tolist(),
                khop_early=bool(rec.answered_early),
                quota=(ok.status, over.status, over.reason),
                replay={k: stats[k] for k in (
                    "requests", "done", "rejected", "layers",
                    "answered_early_frac", "sojourn_layers")})


if __name__ == "__main__":
    main()
