"""Weighted-path (SSSP) throughput of the delta-stepping lane engine on the
GPU (port of ``benchmarks/sssp_bench.py``).

* ``pipelined``: R sources through one pipelined delta-stepping sweep,
  Graph500 R-MAT with uniform (0, 1) weights at ``default_delta``;
* ``unitweight``: the same sweep over unit weights at ``delta = 1``, where
  the bucket walk is the BFS layer walk: its gap to the MS-BFS engine
  prices the dense float lanes;
* ``wcloseness``: sampled weighted closeness, k sources through the
  analytics layer's chunked estimator (``LaneEngine``, chunk = lanes).

Each point is TEPS-equivalent, the reference's work proxy R * (m // 2)
(k * (m // 2) for ``wcloseness``) over the wall time (after one warm-up
call, ending with a device sync).

  python -m repro_torch.benchmarks.sssp_teps --scale 20

(with ``src`` on ``PYTHONPATH``). ``--json PATH`` also writes the points.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.analytics import LaneEngine, weighted_closeness_centrality
from repro_torch.benchmarks.timing import timed
from repro_torch.core.csr import from_weighted_edges
from repro_torch.device import device_name, resolve_device
from repro_torch.graph.generator import rmat_weighted_graph, sample_roots
from repro_torch.traversal.sssp import sssp_pipelined


def unit_weight_graph(wg):
    """The same topology with every edge weighing 1."""
    return from_weighted_edges(wg.src_idx.cpu().numpy(),
                               wg.col_idx.cpu().numpy(), np.ones(wg.m), wg.n,
                               symmetrize=False, drop_self_loops=False,
                               device=wg.device)


def bench_points(scale: int, edgefactor: int = 16, seed: int = 0,
                 sources: int = 32, lanes: int = 32,
                 closeness_sources: int = 32, device=None, graph=None,
                 unit=None) -> dict[str, dict]:
    """{point: {"teps", "seconds", "sources"}} at one scale. ``graph`` (the
    weighted R-MAT graph of these arguments) and ``unit`` (its
    ``unit_weight_graph``) skip building them."""
    dev = resolve_device(device) if graph is None else graph.device
    wg = (rmat_weighted_graph(scale, edgefactor, seed, device=dev)
          if graph is None else graph)
    roots = sample_roots(wg, sources, seed=1)
    r = len(roots)
    points = {}
    dt, _ = timed(lambda: sssp_pipelined(wg, roots, lanes=lanes), dev)
    points[f"pipelined_s{scale}_R{r}"] = dict(
        teps=r * (wg.m // 2) / dt, seconds=dt, sources=r)
    unit = unit_weight_graph(wg) if unit is None else unit
    dt, _ = timed(lambda: sssp_pipelined(unit, roots, delta=1.0,
                                         lanes=lanes), dev)
    points[f"unitweight_s{scale}_R{r}"] = dict(
        teps=r * (unit.m // 2) / dt, seconds=dt, sources=r)
    k = min(closeness_sources, wg.n)
    eng = LaneEngine(wg, lanes=lanes)
    dt, _ = timed(lambda: weighted_closeness_centrality(
        eng, sources=k, seed=2, chunk=lanes), dev)
    points[f"wcloseness_s{scale}_k{k}"] = dict(
        teps=k * (wg.m // 2) / dt, seconds=dt, sources=k)
    return points


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sources", type=int, default=32)
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    ap.add_argument("--json", default=None, help="also write the points")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"# SSSP TEPS-equivalent on {device_name(dev)}: scale={args.scale} "
          f"ef={args.edgefactor} sources={args.sources} lanes={args.lanes}")
    points = bench_points(args.scale, args.edgefactor, args.seed,
                          args.sources, args.lanes, device=dev)
    for name, p in points.items():
        print(f"{name:28s} {p['teps'] / 1e6:10.2f} MTEPS-equiv  "
              f"({p['seconds']:.4f} s)", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(points, f, indent=2, sort_keys=True)
    return points


if __name__ == "__main__":
    main()
