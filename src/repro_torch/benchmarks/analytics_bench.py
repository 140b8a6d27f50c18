"""Analytics workload throughput on the lane engine, on the GPU (port of
``benchmarks/analytics_bench.py``).

One TEPS-equivalent number per workload (higher is better), after one
warm-up call that also builds the kernels. The work numerator is the
reference's fixed proxy per workload, stable across runs by construction
(actual traversal work varies with lane and component collisions):

* ``components``: label the whole graph; numerator = the graph's m/2
  undirected edges (the labelling floor), not per-lane traversal work;
* ``closeness``: sampled-source centrality; numerator = k * m/2;
* ``khop``: a k-hop query batch (S lanes, sliced at depth <= k after full
  traversals); numerator = S * m/2.

  python -m repro_torch.benchmarks.analytics_bench --scale 16

(with ``src`` on ``PYTHONPATH``; ``--device cpu`` for the plain PyTorch
path). ``connected_components`` runs one sweep per 64 unlabelled roots, so
at scale 20, where most components are isolated vertices, it takes
thousands of sweeps. ``--json PATH`` also writes {name: teps}, the
reference's shape. Each point is also a function on a built engine
(``components_point``, ``closeness_point``, ``khop_point``), which returns
(name, work, seconds).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.analytics import (LaneEngine, closeness_centrality,
                                   connected_components, khop_neighborhood)
from repro_torch.benchmarks.timing import timed
from repro_torch.device import device_name, resolve_device
from repro_torch.graph.generator import rmat_graph, sample_roots


def components_point(eng, scale: int, batch: int = 64):
    """(name, work, seconds) of labelling the whole graph; the work is the
    graph's m/2 undirected edges fully labelled (the labelling floor: each
    component's edges are traversed once per covering lane)."""
    dt, _ = timed(lambda: connected_components(eng, batch=batch),
                  eng.g.device)
    return f"components_s{scale}", eng.m // 2, dt


def closeness_point(eng, scale: int, sources: int = 64, batch: int = 64):
    """(name, work, seconds) of sampled closeness: k traversals, most
    covering the giant component."""
    k = min(sources, eng.n)
    dt, _ = timed(lambda: closeness_centrality(eng, sources=k, seed=1,
                                               chunk=batch), eng.g.device)
    return f"closeness_s{scale}_k{k}", k * (eng.m // 2), dt


def khop_point(eng, scale: int, sources: int = 64, k: int = 2):
    """(name, work, seconds) of a k-hop batch: S lanes, sliced at depth
    <= k after full traversals."""
    roots = sample_roots(eng.g, sources, seed=2)
    dt, _ = timed(lambda: khop_neighborhood(eng, roots, k), eng.g.device)
    return f"khop_s{scale}_S{len(roots)}_k{k}", len(roots) * (eng.m // 2), dt


def bench_points(scale: int, edgefactor: int = 16, seed: int = 0,
                 batch: int = 64, closeness_sources: int = 64,
                 khop_sources: int = 64, khop_k: int = 2, ndev: int = 1,
                 device=None) -> dict[str, float]:
    """TEPS-equivalent throughput per analytics workload at one scale."""
    dev = resolve_device(device)
    g = rmat_graph(scale, edgefactor, seed, device=dev)
    eng = LaneEngine(g, ndev=ndev, lanes=None)
    points = {}
    for name, work, dt in (
            components_point(eng, scale, batch),
            closeness_point(eng, scale, closeness_sources, batch),
            khop_point(eng, scale, khop_sources, khop_k)):
        points[name] = work / dt
    return points


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ndev", type=int, default=1,
                    help="devices; above 1 the engine is sharded, and "
                         "every rank of a process group of that size runs "
                         "the bench (launch it with run_ranks or torchrun)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    ap.add_argument("--json", default=None, help="also write the points")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# analytics TEPS-equivalent on {device_name(dev)}: "
          f"scale={args.scale} ef={args.edgefactor}")
    points = bench_points(args.scale, args.edgefactor, args.seed,
                          ndev=args.ndev, device=dev)
    for name, teps in points.items():
        print(f"{name:32s} {teps / 1e6:10.2f} MTEPS-equiv", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(points, f, indent=2, sort_keys=True)
    return points


if __name__ == "__main__":
    main()
