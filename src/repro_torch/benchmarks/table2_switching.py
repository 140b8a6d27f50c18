"""Paper Table 2 analog on the GPU (port of
``benchmarks/table2_switching.py``): the hybrid BFS's per-layer switching
trace.

Prints the layer-by-layer (v_f, e_f, e_u, f, g, approach) table of one
Graph500 BFS, showing the TD -> BU -> TD switching points, read from
``BFSResult.trace_{vf,ef,eu,dir}``.

  python -m repro_torch.benchmarks.table2_switching --scale 20

(with ``src`` on ``PYTHONPATH``; ``--device cpu`` for the plain PyTorch
path).
"""
from __future__ import annotations

import argparse

from repro_torch.core.hybrid import ALPHA_DEFAULT, BETA_DEFAULT, bfs
from repro_torch.graph.generator import rmat_graph, sample_roots


def switching_rows(g, scale: int, edgefactor: int, seed: int = 0):
    """The table's rows for graph ``g`` (the R-MAT graph of ``scale``,
    ``edgefactor`` and ``seed``), printed as they are built."""
    root = int(sample_roots(g, 1, seed=seed + 1)[0])
    out = bfs(g, root, "hybrid")
    n_layers = int(out.num_layers)
    trace = {k: getattr(out, f"trace_{k}").cpu().numpy()
             for k in ("vf", "ef", "eu", "dir")}
    rows = []
    print(f"# Table 2 analog: SCALE={scale} edgefactor={edgefactor} "
          f"root={root}  (alpha={ALPHA_DEFAULT}, beta={BETA_DEFAULT})")
    print(f"{'layer':>5s} {'v_f':>9s} {'e_f':>11s} {'e_u':>12s} "
          f"{'f=e_u/a':>11s} {'g=n/b':>9s} approach")
    for i in range(n_layers):
        vf = int(trace["vf"][i])
        ef = int(trace["ef"][i])
        eu = int(trace["eu"][i])
        f_thr = eu / ALPHA_DEFAULT
        g_thr = g.n / BETA_DEFAULT
        approach = "top-down" if int(trace["dir"][i]) == 0 else "bottom-up"
        print(f"{i + 1:5d} {vf:9d} {ef:11d} {eu:12d} {f_thr:11.0f} "
              f"{g_thr:9.0f} {approach}")
        rows.append(dict(layer=i + 1, v_f=vf, e_f=ef, e_u=eu,
                         approach=approach))
    return rows


def run(scale: int = 12, edgefactor: int = 16, seed: int = 0, device=None):
    g = rmat_graph(scale, edgefactor, seed, device=device)
    return switching_rows(g, scale, edgefactor, seed)


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
