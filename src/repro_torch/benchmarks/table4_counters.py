"""Paper Tables 4-7 analog on the GPU (port of
``benchmarks/table4_counters.py``): per-layer counters and times of the
non-SIMD and the SIMD bottom-up step.

Each layer state of one hybrid traversal is run both ways:

* non-SIMD (paper Algorithm 2): ``bottomup_nosimd_step``, every unvisited
  vertex scans its whole row (``_fallback_scan`` over all m slots);
* SIMD (the paper's vectorised probe): ``bottomup_simd_step``, the
  ``bottom_up_probe`` kernel then the fallback over the residue, skipped
  when the probe retired everything.

Both are the steps the port's ``bfs`` runs. The counters are the ones that
set the cost (active lanes, probe lanes, retired vertices, residue);
times are the best of ``REPS`` host wall times, each call ending in a
device sync, after a warm-up that also builds the kernels.

  python -m repro_torch.benchmarks.table4_counters --scale 20

(with ``src`` on ``PYTHONPATH``; ``--device cpu`` for the plain PyTorch
path).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.bottomup import (bottomup_nosimd_step,
                                       bottomup_probe_stats,
                                       bottomup_simd_step)
from repro_torch.core.hybrid import bfs
from repro_torch.graph.generator import rmat_graph, sample_roots

REPS = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_ms(fn, *args, reps: int = REPS) -> float:
    """Best host wall time of ``fn(*args)`` in ms, each call ending in a
    device sync."""
    dev = args[0].device
    best = float("inf")
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn(*args)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def layer_states(depth: torch.Tensor, layer: int):
    """The bottom-up entry state of ``layer``: (frontier, visited)."""
    return depth == layer - 1, (depth >= 0) & (depth < layer)


def counter_rows(g, scale: int, edgefactor: int, seed: int = 0,
                 max_pos: int = 8):
    """The table's rows for graph ``g`` (the R-MAT graph of ``scale``,
    ``edgefactor`` and ``seed``), printed as they are built."""
    root = int(sample_roots(g, 1, seed=seed + 1)[0])
    out = bfs(g, root, "hybrid")
    depth = out.depth
    n_layers = int(out.num_layers)
    m = g.m

    def simd(f, v, p):
        return bottomup_simd_step(g, f, v, p, max_pos)

    def nosimd(f, v, p):
        return bottomup_nosimd_step(g, f, v, p)

    # warm-up (kernel build) outside the measured region
    f0 = depth == 0
    p0 = torch.full((g.n,), -1, dtype=torch.int32, device=g.device)
    simd(f0, f0, p0)
    nosimd(f0, f0, p0)
    _sync(g.device)

    print(f"# Tables 4-7 analog: SCALE={scale} ef={edgefactor} "
          f"MAX_POS={max_pos}; per-layer bottom-up executed both ways")
    print(f"{'layer':>5s} {'NV':>9s} | {'noSIMD lanes':>12s} {'t(ms)':>8s} | "
          f"{'probe lanes':>11s} {'retired':>8s} {'residue':>8s} "
          f"{'t(ms)':>8s}")
    rows = []
    for layer in range(1, n_layers):
        frontier, visited = layer_states(depth, layer)
        nv = int(torch.count_nonzero(~visited))
        par = torch.full((g.n,), -1, dtype=torch.int32, device=g.device)

        # non-SIMD: every unvisited vertex scans edges -> active lanes = m
        t_no = _best_ms(nosimd, frontier, visited, par)
        st = bottomup_probe_stats(g, frontier, visited, max_pos=max_pos)
        t_si = _best_ms(simd, frontier, visited, par)

        print(f"{layer:5d} {nv:9d} | {m:12d} {t_no:8.2f} | "
              f"{int(st['probe_lanes']):11d} {int(st['retired']):8d} "
              f"{int(st['residue']):8d} {t_si:8.2f}")
        rows.append(dict(layer=layer, nv=nv, nosimd_lanes=m, t_nosimd_ms=t_no,
                         probe_lanes=int(st["probe_lanes"]),
                         retired=int(st["retired"]),
                         residue=int(st["residue"]), t_simd_ms=t_si))
    return rows


def run(scale: int = 12, edgefactor: int = 32, seed: int = 0,
        max_pos: int = 8, device=None):
    g = rmat_graph(scale, edgefactor, seed, device=device)
    return counter_rows(g, scale, edgefactor, seed, max_pos)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edgefactor", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-pos", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    return run(args.scale, args.edgefactor, args.seed, args.max_pos,
               args.device)


if __name__ == "__main__":
    main()
