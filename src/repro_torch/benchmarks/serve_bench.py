"""Serving-path benchmark on the GPU: a replayed mixed-workload trace
through ``repro_torch.serving.AnalyticsService`` (port of
``benchmarks/serve_bench.py``).

One deterministic trace (``serving.trace.synthetic_trace``: bursts of
bfs/khop/reach/closeness/sssp envelopes on the layer clock) is replayed
TWICE through identically configured services: once with the mid-sweep
streaming read-outs on, once answer-at-flush. The run asserts, in-bench:

* **bit parity**: every khop words/counts and reach hops answer is
  identical between the two replays (the streamed depth-k band IS the
  flushed band);
* **early answers**: streamed khop requests resolve at least one layer
  earlier (mean sojourn gain >= 1) than their flush-time twins.

Reported points (higher is better):

* ``mix_teps``: aggregate packed-engine TEPS over the streamed replay;
* ``answered_early_frac``: fraction of answered requests served from the
  mid-sweep read-out;
* ``early_gain_layers``: mean khop sojourn saved by streaming;

and p50/p99 sojourn layers of both replays (lower is better).

  python -m repro_torch.benchmarks.serve_bench --scale 12

(with ``src`` on ``PYTHONPATH``; ``--device cpu`` for the plain PyTorch
path; ``--smoke`` is scale 10 with 32 queries). ``--ndev N`` (N > 1) runs
both replays on sharded services over N ranks (``distributed.ranks
.run_ranks``: one GPU a rank, or gloo ranks with ``--device cpu``); rank 0
is the services' front door and runs the in-bench asserts.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.device import resolve_device

SMOKE_MIX = "bfs:3,khop:3,reach:2,closeness:1,sssp:2"


def _replay(g, trace, *, streaming: bool, lanes: int, slots: int,
            sssp_slots: int, ndev: int, mesh):
    """(service, stats) of one replay; on the ranks > 0 of a sharded
    service the stats are None (the rank followed rank 0)."""
    from repro_torch.serving import AnalyticsService, ServiceConfig
    svc = AnalyticsService(g, ServiceConfig(
        lanes=lanes, slots=slots, sssp_slots=sssp_slots, ndev=ndev,
        mesh=mesh, streaming=streaming))

    def drive(svc):
        svc.warmup(tropical=True)
        return svc.replay(trace)
    return svc, svc.lead(drive)


def bench_points(scale: int, edgefactor: int = 16, seed: int = 0,
                 queries: int = 32, mix: str = SMOKE_MIX,
                 khop_k: int = 2, closeness_sources: int = 8,
                 lanes: int = 0, slots: int = 256, sssp_slots: int = 64,
                 burst: int = 4, every: int = 2, ndev: int = 1,
                 device=None, graph=None, mesh=None) -> dict[str, float]:
    """Streamed-vs-flush replay of one mixed trace; see module doc.
    ``graph`` is the weighted R-MAT graph of ``scale``, ``edgefactor`` and
    ``seed`` when the caller has built it already (it brings its own
    device); by default it is built on ``device``. With ``ndev > 1`` (or
    a 1-D ``mesh``, even of one rank) the services are sharded and every
    rank of the mesh calls it (``run_ranks``): rank 0 returns the points,
    the other ranks None."""
    from repro_torch.graph.generator import rmat_weighted_graph
    from repro_torch.serving.trace import synthetic_trace

    g = graph if graph is not None else rmat_weighted_graph(
        scale, edgefactor, seed, device=resolve_device(device))

    def trace():
        # ids are fresh per build; the two replays match by index
        return synthetic_trace(
            g.n, queries, mix=mix, seed=seed, khop_k=khop_k,
            closeness_sources=closeness_sources, burst=burst, every=every)

    kw = dict(lanes=lanes, slots=slots, sssp_slots=sssp_slots, ndev=ndev,
              mesh=mesh)
    t_on, t_off = trace(), trace()
    svc_on, s_on = _replay(g, t_on, streaming=True, **kw)
    svc_off, s_off = _replay(g, t_off, streaming=False, **kw)
    if s_on is None:
        return None                       # a follower of the front door

    gains = []
    for env_on, env_off in zip(t_on, t_off):
        r_on = svc_on.record(env_on.id)
        r_off = svc_off.record(env_off.id)
        if r_on.kind != r_off.kind:
            raise AssertionError(f"replays diverged at {env_on.id}")
        if r_on.kind == "khop":
            a, b = r_on.answer.result, r_off.answer.result
            if not (np.array_equal(a.words, b.words)
                    and np.array_equal(a.counts, b.counts)):
                raise AssertionError(
                    "streamed khop band diverged from the flushed band")
            gains.append(r_off.sojourn - r_on.sojourn)
        elif r_on.kind == "reach":
            a, b = r_on.answer.result, r_off.answer.result
            if not np.array_equal(a.hops, b.hops):
                raise AssertionError(
                    "streamed reach hops diverged from the flushed answer")
    gain = float(np.mean(gains)) if gains else 0.0
    if gain < 1.0:
        raise AssertionError(
            f"streaming khop answers must land >= 1 layer before flush on "
            f"the trace, measured mean gain {gain}")

    return {
        f"mix_teps_s{scale}_q{queries}":
            s_on["aggregate_mteps"] * 1e6,
        f"answered_early_frac_s{scale}_q{queries}":
            s_on["answered_early_frac"],
        f"early_gain_layers_s{scale}_q{queries}": gain,
        # lower-is-better latency points
        f"p50_sojourn_layers_s{scale}_q{queries}":
            s_on["sojourn_layers"]["p50"],
        f"p99_sojourn_layers_s{scale}_q{queries}":
            s_on["sojourn_layers"]["p99"],
        f"p50_sojourn_layers_flush_s{scale}_q{queries}":
            s_off["sojourn_layers"]["p50"],
        f"p99_sojourn_layers_flush_s{scale}_q{queries}":
            s_off["sojourn_layers"]["p99"],
    }


def bench_rank(graph_path, scale, edgefactor, seed, kw, device):
    """One rank of ``--ndev N``: ``bench_points`` on the graph from
    ``graph_path``, on this rank's device."""
    from repro_torch.distributed.ranks import load_graph, rank_device
    return bench_points(scale, edgefactor, seed, device=device,
                        graph=load_graph(graph_path, rank_device(device)),
                        **kw)


def _bench_ranks(scale, edgefactor, seed, kw, device):
    """The graph built once here, saved, and benched by ``kw['ndev']``
    ranks. Returns rank 0's points."""
    import os
    import tempfile

    import torch

    from repro_torch.distributed.ranks import run_ranks, save_graph
    from repro_torch.graph.generator import rmat_weighted_graph
    g = rmat_weighted_graph(scale, edgefactor, seed,
                            device=resolve_device(device))
    on_cpu = g.device.type == "cpu"
    with tempfile.TemporaryDirectory(prefix="serve_bench_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(g, path)
        del g
        if not on_cpu:
            torch.cuda.empty_cache()    # the ranks need the card's memory
        rank_dev = "cpu" if on_cpu else None
        return run_ranks(bench_rank, kw["ndev"], path, scale, edgefactor,
                         seed, kw, rank_dev, device=rank_dev)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--mix", default=SMOKE_MIX)
    ap.add_argument("--lanes", type=int, default=0)
    ap.add_argument("--slots", type=int, default=256)
    ap.add_argument("--ndev", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="fast point: scale 10, 32 queries")
    ap.add_argument("--json", default=None, help="write {name: value} here")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    args = ap.parse_args(argv)

    scale = 10 if args.smoke else args.scale
    queries = 32 if args.smoke else args.queries
    kw = dict(queries=queries, mix=args.mix, lanes=args.lanes,
              slots=args.slots, ndev=args.ndev)
    if args.ndev > 1:
        points = _bench_ranks(scale, args.edgefactor, args.seed, kw,
                              args.device)
    else:
        points = bench_points(scale, args.edgefactor, args.seed,
                              device=args.device, **kw)
    for name, v in points.items():
        if "teps" in name:
            print(f"{name:44s} {v / 1e6:10.2f} MTEPS")
        else:
            print(f"{name:44s} {v:10.3f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(points, f, indent=2, sort_keys=True)
        print(f"wrote {args.json}")
    return points


if __name__ == "__main__":
    main()
