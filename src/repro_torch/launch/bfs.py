"""Graph500 BFS entry point (the paper's experiment), on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.bfs --scale 20 --edgefactor 16 \
      --mode hybrid --roots 64 [--validate] [--device cuda|cpu]

Modes: hybrid | hybrid_nosimd | topdown | bottomup_simd | bottomup_nosimd.
Prints the run's summary as JSON.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.graph.graph500 import run_graph500


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--mode", default="hybrid",
                    choices=["hybrid", "hybrid_nosimd", "topdown",
                             "bottomup_simd", "bottomup_nosimd"])
    ap.add_argument("--roots", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--alpha", type=float, default=14.0)
    ap.add_argument("--beta", type=float, default=24.0)
    ap.add_argument("--max-pos", type=int, default=8)
    ap.add_argument("--validate", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    args = ap.parse_args(argv)

    res = run_graph500(args.scale, args.edgefactor, mode=args.mode,
                       num_roots=args.roots, seed=args.seed,
                       validate=args.validate, alpha=args.alpha,
                       beta=args.beta, max_pos=args.max_pos,
                       device=args.device)
    print(json.dumps(res.summary(), indent=2))


if __name__ == "__main__":
    main()
