"""Capture a Perfetto trace and a metrics scrape of a mixed-workload serve
run (port of ``examples/sweep_trace.py``).

  python -m repro_torch.examples.sweep_trace [--out-dir out] [--device cpu]

Replays a deterministic mixed BFS/k-hop/SSSP workload through the
AnalyticsService with a ``Telemetry`` bundle attached, then exports under
``--out-dir`` (``out/`` by default, git-ignored):

* ``sweep_trace.json``: Chrome trace-event JSON: request lifecycles
  (QUEUED -> RUNNING spans, early-readout markers) plus one track per
  recorded engine sweep with per-layer TD/BU spans and frontier-density
  counters. Open it at https://ui.perfetto.dev ("Open trace file").
* ``sweep_metrics.txt``: Prometheus text exposition of the service
  counters (requests by kind/status, sojourn histogram, engine layers,
  edges relaxed).
"""
from __future__ import annotations

import argparse
import os

from repro_torch.device import resolve_device
from repro_torch.graph.generator import rmat_weighted_graph
from repro_torch.obs import Telemetry, write_chrome_trace
from repro_torch.serving import (AnalyticsService, ServiceConfig,
                                 synthetic_trace)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default="out")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    trace_out = os.path.join(args.out_dir, "sweep_trace.json")
    metrics_out = os.path.join(args.out_dir, "sweep_metrics.txt")
    os.makedirs(args.out_dir, exist_ok=True)

    wg = rmat_weighted_graph(10, 16, seed=7, device=dev)
    tel = Telemetry()
    svc = AnalyticsService(wg, ServiceConfig(lanes=64, slots=64,
                                             sssp_slots=16, telemetry=tel))
    trace = synthetic_trace(wg.n, 24, mix="bfs:3,khop:2,reach:1,sssp:1",
                            seed=3)
    stats = svc.replay(trace)

    write_chrome_trace(trace_out, svc.trace_events())
    with open(metrics_out, "w") as f:
        f.write(svc.metrics_text())

    sweeps = [r.summary() for r in tel.sweeps]
    print(f"n={wg.n:,}  requests={stats['requests']}  "
          f"done={stats['done']}  layers={stats['layers']}  "
          f"answered_early={stats['answered_early_frac']:.0%}")
    for s in sweeps:
        print(f"  sweep {s['engine']:>6} ({s['kind']}): {s['layers']} "
              f"layers, {s['edges_relaxed']:,} edges relaxed")
    print(f"wrote {trace_out} (open in https://ui.perfetto.dev) "
          f"and {metrics_out}")
    return dict(requests=stats["requests"], done=stats["done"],
                layers=stats["layers"],
                answered_early_frac=stats["answered_early_frac"],
                sweeps=[(s["engine"], s["kind"], s["layers"],
                         s["edges_relaxed"]) for s in sweeps],
                trace_out=trace_out, metrics_out=metrics_out)


if __name__ == "__main__":
    main()
