"""Paper Figure 3 analog on the GPU (port of ``benchmarks/fig3_teps.py``):
harmonic-mean TEPS across SCALE x edgefactor for the SIMD hybrid (ours),
the non-SIMD hybrid (the paper's blue line) and the pure top-down
baseline, each through the serial Graph500 harness (``run_graph500``).

  python -m repro_torch.benchmarks.fig3_teps --scales 20 --edgefactors 16 32

(with ``src`` on ``PYTHONPATH``; ``--device cpu`` for the plain PyTorch
path).
"""
from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.graph.generator import rmat_graph
from repro_torch.graph.graph500 import run_graph500

MODES = ("hybrid", "hybrid_nosimd", "topdown")


def teps_point(g, scale: int, edgefactor: int, mode: str, roots: int,
               seed: int = 0) -> float:
    """Harmonic-mean TEPS of one mode on graph ``g`` (the R-MAT graph of
    ``scale``, ``edgefactor`` and ``seed``)."""
    return run_graph500(scale, edgefactor, mode=mode, num_roots=roots,
                        seed=seed, graph=g).harmonic_mean_teps


def run(scales=(10, 11, 12), edgefactors=(16, 32, 64), roots: int = 8,
        seed: int = 0, device=None):
    dev = resolve_device(device)
    print("# Fig 3 analog: harmonic-mean TEPS")
    print(f"{'scale':>5s} {'ef':>3s} " + " ".join(f"{m:>16s}" for m in MODES))
    results = {}
    for ef in edgefactors:
        for sc in scales:
            g = rmat_graph(sc, ef, seed, device=dev)
            vals = []
            for mode in MODES:
                teps = teps_point(g, sc, ef, mode, roots, seed)
                results[(sc, ef, mode)] = teps
                vals.append(teps)
            print(f"{sc:5d} {ef:3d} " + " ".join(f"{v:16,.0f}" for v in vals))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scales", type=int, nargs="+", default=[10, 11, 12])
    ap.add_argument("--edgefactors", type=int, nargs="+",
                    default=[16, 32, 64])
    ap.add_argument("--roots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    return run(tuple(args.scales), tuple(args.edgefactors), args.roots,
               args.seed, args.device)


if __name__ == "__main__":
    main()
