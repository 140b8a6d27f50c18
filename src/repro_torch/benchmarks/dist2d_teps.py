"""2-D partitioned MS-BFS: TEPS and bytes exchanged a layer (port of
``benchmarks/dist2d_teps.py``).

Runs the 2-D grid engine (``repro_torch.core.dist2d``) for each grid shape
and wire format against the host pipelined engine in this process. Each
grid is one launch of ``pr * pc`` ranks (``distributed.ranks.run_ranks``):
NCCL, one GPU a rank, so on the GPU only grids up to the card count run
and larger ones raise; ``--device cpu`` runs gloo ranks on the CPU, where
the ranks share the cores and the TEPS column shows the cost of the 2-D
form (two exchanges a layer), not scaling. The second column is what the
decomposition is for: bytes exchanged a layer, which the dense format
ships in proportion to the graph and the compressed one in proportion to
the frontier; ``xreduction`` is the dense bytes over the compressed bytes
(higher is better). The graph is built once, here, and handed to the
ranks by file.

  python -m repro_torch.benchmarks.dist2d_teps --scale 20 --grids 1x1
  python -m repro_torch.benchmarks.dist2d_teps --smoke --device cpu \\
      --json out/dist2d.json

(with ``src`` on ``PYTHONPATH``). ``--validate`` holds every point's depths
to the host engine's (a sha256 of the depth array). ``--json PATH`` also
writes {label: value}, the reference's shape.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.device import device_name, resolve_device
from repro_torch.distributed.ranks import (load_graph, rank_device,
                                           run_ranks, save_graph)
from repro_torch.graph.generator import rmat_graph, sample_roots

FORMATS = ((False, "dense"), (True, "comp"))


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parse_grids(specs) -> list[tuple[int, int]]:
    """["2x2", "1x4"] -> [(2, 2), (1, 4)]."""
    return [tuple(int(x) for x in s.split("x")) for s in specs]


def check_ranks(dev: torch.device, grids) -> None:
    need = max(pr * pc for pr, pc in grids)
    if dev.type == "cuda" and need > torch.cuda.device_count():
        raise RuntimeError(
            f"grid of {need} ranks needs that many GPUs (one a rank), and "
            f"{torch.cuda.device_count()} are available")


def grid_rank(graph_path, pr, pc, sweeps, mode, device):
    """One rank of a grid point: for each (R, lanes, roots) in ``sweeps``
    and each wire format, a warm-up sweep and a timed one of the 2-D
    engine. Returns {(R, tag): (seconds, bytes, layers, depth digest)}."""
    from repro_torch.core.dist2d import (dist2d_msbfs_engine_drain,
                                         dist2d_msbfs_engine_enqueue,
                                         dist2d_msbfs_engine_init,
                                         dist2d_msbfs_engine_result, mesh2d,
                                         partition_graph_2d)
    dev = rank_device(device)
    g = load_graph(graph_path, dev)
    mesh = mesh2d(pr, pc, device)
    dg = partition_graph_2d(g, pr, pc)
    out = {}
    for r, width, roots in sweeps:
        for compress, tag in FORMATS:
            def sweep():
                s = dist2d_msbfs_engine_init(dg, mesh, capacity=r,
                                             lanes=width)
                s = dist2d_msbfs_engine_enqueue(s, roots)
                return dist2d_msbfs_engine_drain(dg, s, mesh, mode,
                                                 compress=compress)
            s = sweep()
            depth = digest(dist2d_msbfs_engine_result(
                dg, s, mesh, derive_parents=False).depth)
            sync(dev)
            t0 = time.perf_counter()
            s = sweep()
            sync(dev)
            out[r, tag] = (time.perf_counter() - t0, int(s.exch_bytes),
                           max(int(s.sweep_layers), 1), depth)
    return out


def run_curve(scale: int, edgefactor: int, grids, roots_curve, mode: str,
              seed: int, lanes: int | None, validate: bool,
              device=None) -> dict:
    """TEPS and bytes-a-layer points per (grid, R, wire format), the host
    engine's TEPS per R (``host_R{R}``) and ``xreduction`` per (grid, R).
    Returns {label: value}."""
    from repro_torch.core.msbfs import msbfs_pipelined
    from repro_torch.core.packed import adaptive_lane_pool
    dev = resolve_device(device)
    rank_dev = "cpu" if dev.type == "cpu" else None
    check_ranks(dev, grids)
    g = rmat_graph(scale, edgefactor, seed, device=dev)
    print(f"# 2-D MS-BFS TEPS on {device_name(dev)}: scale={scale} "
          f"ef={edgefactor} mode={mode} grids={list(grids)} "
          f"R={list(roots_curve)} lanes={'auto' if not lanes else lanes}")
    print(f"  n={g.n:,} vertices, m={g.m:,} directed edges", flush=True)
    points: dict[str, float] = {}
    sweeps, edges, want = [], {}, {}
    for r in roots_curve:
        roots = sample_roots(g, r, seed=seed)
        width = lanes or adaptive_lane_pool(r, g.n, g.m)
        msbfs_pipelined(g, roots, mode, lanes=width, derive_parents=False)
        sync(dev)
        t0 = time.perf_counter()
        base = msbfs_pipelined(g, roots, mode, lanes=width,
                               derive_parents=False)
        sync(dev)
        base_t = time.perf_counter() - t0
        edges[r] = float(base.edges_traversed.sum(dtype=torch.int64)) / 2
        want[r] = digest(base.depth)
        points[f"host_R{r}"] = edges[r] / base_t
        print(f"  host engine      R={r:4d}: "
              f"{points[f'host_R{r}'] / 1e6:10.2f} MTEPS (lanes={width})",
              flush=True)
        sweeps.append((r, width, roots))
        del base
    with tempfile.TemporaryDirectory(prefix="dist2d_teps_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(g, path)
        if dev.type == "cuda":
            del g
            torch.cuda.empty_cache()    # the ranks need the card's memory
        for pr, pc in grids:
            got = run_ranks(grid_rank, pr * pc, path, pr, pc, sweeps, mode,
                            rank_dev, device=rank_dev)
            for r in roots_curve:
                label = f"g{pr}x{pc}_R{r}"
                for _, tag in FORMATS:
                    dt, nbytes, layers, depth = got[r, tag]
                    if validate and depth != want[r]:
                        raise AssertionError(
                            f"grid {pr}x{pc} {tag} R={r}: depths differ "
                            f"from the host engine's")
                    teps, bpl = edges[r] / dt, nbytes / layers
                    points[f"{label}_{tag}"] = teps
                    points[f"{label}_{tag}_bytes_per_layer"] = bpl
                    rel = teps / max(points[f"host_R{r}"], 1e-12)
                    print(f"  grid {pr}x{pc} {tag:5s} R={r:4d}: "
                          f"{teps / 1e6:10.2f} MTEPS ({rel:5.2f}x host), "
                          f"{bpl / 1024:10.1f} KiB/layer over {layers} "
                          f"layers", flush=True)
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
    ap.add_argument("--roots", type=int, nargs="+", default=[64, 256])
    ap.add_argument("--mode", default="hybrid",
                    choices=("hybrid", "topdown", "bottomup"))
    ap.add_argument("--lanes", type=int, default=0,
                    help="bit-lane pool; 0 = adaptive sizing")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validate", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: scale 10, grid 2x2, R=64, validated")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one); cpu runs gloo ranks")
    ap.add_argument("--json", default=None,
                    help="write {label: value} to this path")
    args = ap.parse_args(argv)
    if args.smoke:
        args.scale, args.grids, args.roots = 10, ["2x2"], [64]
        args.validate = True
    points = run_curve(args.scale, args.edgefactor, parse_grids(args.grids),
                       args.roots, args.mode, args.seed, args.lanes or None,
                       args.validate, args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(points, f, indent=2, sort_keys=True)
        print(f"  wrote {args.json}")
    return points


if __name__ == "__main__":
    main()
