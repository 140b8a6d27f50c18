"""Paper Table 3 analog on the GPU (port of ``benchmarks/table3_maxpos.py``):
the probe-depth statistics that justify MAX_POS = 8.

For each layer of a hybrid traversal, rebuilds the bottom-up entry state
and reports, for the vertices that find a parent this layer, the fraction
the ``bottom_up_probe`` kernel retires within MAX_POS in {1, 2, 4, 8, 16}
probe positions, plus the fallback residue at MAX_POS = 8.

  python -m repro_torch.benchmarks.table3_maxpos --scale 20

(with ``src`` on ``PYTHONPATH``; ``--device cpu`` for the plain PyTorch
path).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.bottomup import bottomup_probe_stats
from repro_torch.core.hybrid import bfs
from repro_torch.graph.generator import rmat_graph, sample_roots

MAX_POS_SWEEP = (1, 2, 4, 8, 16)


def maxpos_rows(g, scale: int, edgefactor: int, seed: int = 0):
    """The table's rows for graph ``g`` (the R-MAT graph of ``scale``,
    ``edgefactor`` and ``seed``), printed as they are built."""
    root = int(sample_roots(g, 1, seed=seed + 1)[0])
    out = bfs(g, root, "hybrid")
    depth = out.depth
    n_layers = int(out.num_layers)
    print(f"# Table 3 analog: SCALE={scale} edgefactor={edgefactor}")
    header = " ".join(f"ret@{mp:<3d}" for mp in MAX_POS_SWEEP)
    print(f"{'layer':>5s} {'unvisited':>10s} {'found':>9s} {header} residue@8")
    rows = []
    for layer in range(1, n_layers):
        visited = (depth >= 0) & (depth < layer)
        frontier = depth == layer - 1
        found = int((depth == layer).sum())
        if found == 0:
            continue
        fracs = []
        residue8 = 0
        for mp in MAX_POS_SWEEP:
            st = bottomup_probe_stats(g, frontier, visited, max_pos=mp)
            fracs.append(int(st["retired"]) / max(found, 1))
            if mp == 8:
                residue8 = int(st["residue"])
        unvisited = int(torch.count_nonzero(~visited))
        print(f"{layer:5d} {unvisited:10d} {found:9d} "
              + " ".join(f"{f:7.3f}" for f in fracs) + f" {residue8:9d}")
        rows.append(dict(layer=layer, found=found,
                         retired_frac={mp: f for mp, f in
                                       zip(MAX_POS_SWEEP, fracs)},
                         residue8=residue8))
    return rows


def run(scale: int = 12, edgefactor: int = 16, seed: int = 0, device=None):
    g = rmat_graph(scale, edgefactor, seed, device=device)
    return maxpos_rows(g, scale, edgefactor, seed)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    return run(args.scale, args.edgefactor, args.seed, args.device)


if __name__ == "__main__":
    main()
