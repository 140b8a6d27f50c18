"""Distributed MS-BFS TEPS: the sharded bit-lane engine against the host
engine (port of ``benchmarks/dist_msbfs_teps.py``).

Runs the pipelined packed engine over a 1-D partitioned graph
(``repro_torch.core.dist_msbfs``) on ``ndev`` ranks for each ``--ndev`` and
each root count R, against the host pipelined engine in this process. Each
``ndev`` point is one launch of ``ndev`` ranks (``distributed.ranks
.run_ranks``): NCCL, one GPU a rank, so on the GPU only ``ndev`` up to the
card count runs and more raises; ``--device cpu`` runs gloo ranks on the
CPU, where the ranks share the cores and the curve shows the cost of the
distributed form (the counter all-reduce and the row all-gather each layer),
not scaling. The graph is built once, here, and handed to the ranks by
file. Every point's engine equals the host engine bit for bit; the
reference's ``ndev1`` point runs its host engine, the port's runs the
sharded engine on one rank.

  python -m repro_torch.benchmarks.dist_msbfs_teps --scale 20 --ndev 1
  python -m repro_torch.benchmarks.dist_msbfs_teps --smoke --device cpu \\
      --json out/dist.json

(with ``src`` on ``PYTHONPATH``). Prints one line a point; ``--json PATH``
also writes {label: aggregate TEPS}, the reference's shape.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch.device import device_name, resolve_device
from repro_torch.distributed.ranks import (load_graph, rank_device,
                                           run_ranks, save_graph)
from repro_torch.graph.generator import rmat_graph
from repro_torch.graph.graph500 import run_graph500


def curve_rank(graph_path, scale, edgefactor, roots_curve, mode, seed,
               lanes, validate, device):
    """One rank of an ``ndev`` point: the batched Graph500 harness on the
    sharded engine at every root count. Returns {R: (aggregate TEPS,
    lanes)}."""
    import torch.distributed as dist

    from repro_torch.core.dist_msbfs import host_mesh
    g = load_graph(graph_path, rank_device(device))
    mesh = host_mesh(dist.get_world_size(), device)
    out = {}
    for r in roots_curve:
        res = run_graph500(scale, edgefactor, mode=mode, num_roots=r,
                           seed=seed, graph=g, batched=True, lanes=lanes,
                           mesh=mesh, validate=validate)
        out[r] = (res.aggregate_teps, res.lanes)
    return out


def run_curve(scale: int, edgefactor: int, ndevs, roots_curve, mode: str,
              seed: int, lanes: int | None, validate: bool,
              device=None) -> dict:
    """Aggregate TEPS per (ndev, R) point, and the host engine's per R
    (``host_R{R}``). Returns {label: teps}."""
    dev = resolve_device(device)
    rank_dev = "cpu" if dev.type == "cpu" else None
    if dev.type == "cuda" and max(ndevs) > torch.cuda.device_count():
        raise RuntimeError(
            f"--ndev {max(ndevs)} needs that many GPUs (one a rank), and "
            f"{torch.cuda.device_count()} are available")
    g = rmat_graph(scale, edgefactor, seed, device=dev)
    print(f"# dist MS-BFS TEPS on {device_name(dev)}: scale={scale} "
          f"ef={edgefactor} mode={mode} ndev={list(ndevs)} "
          f"R={list(roots_curve)} lanes={'auto' if not lanes else lanes}")
    print(f"  n={g.n:,} vertices, m={g.m:,} directed edges "
          f"({g.m // 2:,} undirected)", flush=True)
    points: dict[str, float] = {}
    for r in roots_curve:
        base = run_graph500(scale, edgefactor, mode=mode, num_roots=r,
                            seed=seed, graph=g, batched=True, lanes=lanes,
                            validate=validate)
        points[f"host_R{r}"] = base.aggregate_teps
        print(f"  host engine  R={r:4d}: {base.aggregate_teps / 1e6:10.2f} "
              f"MTEPS (lanes={base.lanes})", flush=True)
    with tempfile.TemporaryDirectory(prefix="dist_msbfs_teps_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(g, path)
        if dev.type == "cuda":
            del g
            torch.cuda.empty_cache()    # the ranks need the card's memory
        for ndev in ndevs:
            curve = run_ranks(curve_rank, ndev, path, scale, edgefactor,
                              tuple(roots_curve), mode, seed, lanes,
                              validate, rank_dev, device=rank_dev)
            for r, (teps, used) in curve.items():
                points[f"ndev{ndev}_R{r}"] = teps
                rel = teps / max(points[f"host_R{r}"], 1e-12)
                print(f"  sharded ndev={ndev} R={r:4d}: {teps / 1e6:10.2f} "
                      f"MTEPS ({rel:5.2f}x the host engine, lanes={used})",
                      flush=True)
    assert all(np.isfinite(v) for v in points.values())
    return points


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--ndev", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--roots", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--mode", default="hybrid",
                    choices=("hybrid", "topdown", "bottomup_simd"))
    ap.add_argument("--lanes", type=int, default=0,
                    help="bit-lane pool; 0 = adaptive sizing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validate", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: scale 10, ndev {1,2}, R=64")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one); cpu runs gloo ranks")
    ap.add_argument("--json", default=None,
                    help="write {label: teps} to this path")
    args = ap.parse_args(argv)
    if args.smoke:
        args.scale, args.ndev, args.roots = 10, [1, 2], [64]
    points = run_curve(args.scale, args.edgefactor, args.ndev, args.roots,
                       args.mode, args.seed, args.lanes or None,
                       args.validate, args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(points, f, indent=2, sort_keys=True)
        print(f"  wrote {args.json}")
    return points


if __name__ == "__main__":
    main()
