"""Distributed delta-stepping SSSP: TEPS-equivalents and bytes a step (port
of ``benchmarks/dist_sssp_teps.py``).

Runs the 2-D grid SSSP engine (``repro_torch.core.dist_sssp``) for each
grid shape and wire format against the host pipelined engine in this
process, as ``dist2d_teps`` runs the MS-BFS engine: one launch of ``pr *
pc`` ranks a grid (NCCL, one GPU a rank; ``--device cpu`` for gloo ranks,
which share the cores, so the column shows the cost of the sharded form,
an expand and a MIN-fold a step, not scaling). The work numerator is the
fixed proxy of ``sssp_teps`` (R traversals x m/2 undirected edges). The
second column is bytes exchanged a step: dense value exchanges ship every
entry, compressed ones the finite entries (a candidate is ``inf`` wherever
no relaxation fired); ``xreduction`` is the dense bytes over the
compressed bytes.

  python -m repro_torch.benchmarks.dist_sssp_teps --scale 20 --grids 1x1
  python -m repro_torch.benchmarks.dist_sssp_teps --smoke --device cpu

(with ``src`` on ``PYTHONPATH``). ``--validate`` holds every point's
distances to the host engine's (a sha256 of the float32 array).
``--json PATH`` also writes {label: value}, the reference's shape.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.benchmarks.dist2d_teps import (FORMATS, check_ranks, digest,
                                                parse_grids, sync)
from repro_torch.device import device_name, resolve_device
from repro_torch.distributed.ranks import (load_graph, rank_device,
                                           run_ranks, save_graph)
from repro_torch.graph.generator import rmat_weighted_graph, sample_roots


def grid_rank(graph_path, pr, pc, sweeps, delta, device):
    """One rank of a grid point: for each (R, lanes, roots) in ``sweeps``
    and each wire format, a warm-up sweep and a timed one of the 2-D SSSP
    engine. Returns {(R, tag): (seconds, bytes, steps, dist digest)}."""
    from repro_torch.core.dist_sssp import (dist2d_sssp_engine_drain,
                                            dist2d_sssp_engine_enqueue,
                                            dist2d_sssp_engine_init,
                                            dist2d_sssp_engine_result, mesh2d,
                                            partition_weighted_graph_2d)
    dev = rank_device(device)
    wg = load_graph(graph_path, dev)
    mesh = mesh2d(pr, pc, device)
    dwg2 = partition_weighted_graph_2d(wg, pr, pc)
    out = {}
    for r, width, roots in sweeps:
        for compress, tag in FORMATS:
            def sweep():
                s = dist2d_sssp_engine_init(dwg2, mesh, capacity=r,
                                            lanes=width)
                s = dist2d_sssp_engine_enqueue(s, roots)
                return dist2d_sssp_engine_drain(dwg2, s, mesh, delta,
                                                compress=compress)
            s = sweep()
            dist = digest(dist2d_sssp_engine_result(dwg2, s).dist)
            sync(dev)
            t0 = time.perf_counter()
            s = sweep()
            sync(dev)
            out[r, tag] = (time.perf_counter() - t0, int(s.exch_bytes),
                           max(int(s.sweep_steps), 1), dist)
    return out


def run_curve(scale: int, edgefactor: int, grids, roots_curve, seed: int,
              lanes: int, validate: bool, device=None) -> dict:
    """TEPS-equivalent and bytes-a-step points per (grid, R, wire format),
    the host engine's per R (``host_R{R}``) and ``xreduction`` per (grid,
    R). Returns {label: value}."""
    from repro_torch.traversal.sssp import default_delta, sssp_pipelined
    dev = resolve_device(device)
    rank_dev = "cpu" if dev.type == "cpu" else None
    check_ranks(dev, grids)
    wg = rmat_weighted_graph(scale, edgefactor, seed, device=dev)
    delta = float(default_delta(wg))
    print(f"# dist SSSP TEPS-equiv on {device_name(dev)}: scale={scale} "
          f"ef={edgefactor} grids={list(grids)} R={list(roots_curve)} "
          f"lanes={lanes} delta={delta:.4g}")
    print(f"  n={wg.n:,} vertices, m={wg.m:,} directed edges", flush=True)
    points: dict[str, float] = {}
    sweeps, work, want = [], {}, {}
    for r in roots_curve:
        roots = sample_roots(wg.csr, r, seed=seed)
        width = max(1, min(lanes, r))
        work[r] = r * (wg.m // 2)
        sssp_pipelined(wg, roots, delta=delta, lanes=width)
        sync(dev)
        t0 = time.perf_counter()
        base = sssp_pipelined(wg, roots, delta=delta, lanes=width)
        sync(dev)
        points[f"host_R{r}"] = work[r] / (time.perf_counter() - t0)
        want[r] = digest(base.dist)
        print(f"  host engine      R={r:4d}: "
              f"{points[f'host_R{r}'] / 1e6:10.2f} MTEPS-equiv", flush=True)
        sweeps.append((r, width, roots))
        del base
    with tempfile.TemporaryDirectory(prefix="dist_sssp_teps_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(wg, path)
        if dev.type == "cuda":
            del wg
            torch.cuda.empty_cache()    # the ranks need the card's memory
        for pr, pc in grids:
            got = run_ranks(grid_rank, pr * pc, path, pr, pc, sweeps, delta,
                            rank_dev, device=rank_dev)
            for r in roots_curve:
                label = f"g{pr}x{pc}_R{r}"
                for _, tag in FORMATS:
                    dt, nbytes, steps, dist = got[r, tag]
                    if validate and dist != want[r]:
                        raise AssertionError(
                            f"grid {pr}x{pc} {tag} R={r}: distances differ "
                            f"from the host engine's")
                    teps, bps = work[r] / dt, nbytes / steps
                    points[f"{label}_{tag}"] = teps
                    points[f"{label}_{tag}_bytes_per_step"] = bps
                    rel = teps / max(points[f"host_R{r}"], 1e-12)
                    print(f"  grid {pr}x{pc} {tag:5s} R={r:4d}: "
                          f"{teps / 1e6:10.2f} MTEPS-equiv ({rel:5.2f}x "
                          f"host), {bps / 1024:10.1f} KiB/step over {steps} "
                          f"steps", flush=True)
                red = got[r, "dense"][1] / max(got[r, "comp"][1], 1)
                points[f"{label}_xreduction"] = red
                print(f"  grid {pr}x{pc} exchange volume: {red:5.2f}x less "
                      f"compressed", flush=True)
    assert all(np.isfinite(v) for v in points.values())
    return points


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--grids", type=str, nargs="+",
                    default=["1x2", "2x1", "2x2"],
                    help="grid shapes as PRxPC")
    ap.add_argument("--roots", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--lanes", type=int, default=32,
                    help="dense tropical lane pool per sweep")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validate", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: scale 10, grid 2x2, R=32, validated")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one); cpu runs gloo ranks")
    ap.add_argument("--json", default=None,
                    help="write {label: value} to this path")
    args = ap.parse_args(argv)
    if args.smoke:
        args.scale, args.grids, args.roots = 10, ["2x2"], [32]
        args.validate = True
    points = run_curve(args.scale, args.edgefactor, parse_grids(args.grids),
                       args.roots, args.seed, args.lanes, args.validate,
                       args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(points, f, indent=2, sort_keys=True)
        print(f"  wrote {args.json}")
    return points


if __name__ == "__main__":
    main()
