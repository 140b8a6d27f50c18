"""The paper's hillclimb on the GPU: measured Graph500 TEPS per setting
(port of ``benchmarks/bfs_hillclimb.py``).

Baseline-to-optimized ladder, harmonic-mean TEPS across roots through the
serial harness (``run_graph500``):

  B0  topdown            pure top-down (no direction optimization)
  B1  bottomup_nosimd    pure Algorithm-2 bottom-up
  B2  hybrid_nosimd      hybrid with non-SIMD bottom-up (paper baseline)
  B3  hybrid             + vectorised probe, MAX_POS=8 (paper-faithful)
  O1  hybrid, no fallback-skip   (the empty-residue skip ablated)
  O2  MAX_POS sweep      {2, 4, 8, 16, 32}
  O3  alpha/beta sweep   switching thresholds
  O4  ELL top-down       bounded 16-slot slabs plus a residue scan

  python -m repro_torch.benchmarks.bfs_hillclimb --scale 20 --edgefactor 16

(with ``src`` on ``PYTHONPATH``; ``--device cpu`` for the plain PyTorch
path). Writes ``out/bfs_perf_s{scale}_ef{edgefactor}.json`` (``--out``
names another directory).
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.device import device_name, resolve_device
from repro_torch.graph.generator import rmat_graph
from repro_torch.graph.graph500 import run_graph500

LADDER = (("B0_topdown", dict(mode="topdown")),
          ("B1_bottomup_nosimd", dict(mode="bottomup_nosimd")),
          ("B2_hybrid_nosimd", dict(mode="hybrid_nosimd")),
          ("B3_hybrid_simd", dict(mode="hybrid")))
MAX_POS_SWEEP = (2, 4, 8, 16, 32)
ALPHA_BETA_SWEEP = ((4.0, 24.0), (8.0, 24.0), (14.0, 24.0), (28.0, 24.0),
                    (14.0, 8.0), (14.0, 64.0))
ELL_TOPDOWN = (("O4_ell_topdown", dict(mode="hybrid", td_impl="ell")),
               ("O4_ell_td_alpha4", dict(mode="hybrid", td_impl="ell",
                                         alpha=4.0)),
               ("O4_ell_pure_td", dict(mode="topdown", td_impl="ell")))


def points():
    """Every point in the reference's order: (section of the JSON, key in
    it, printed label, ``run_graph500`` knobs)."""
    out = [("ladder", tag, tag, kw) for tag, kw in LADDER]
    out.append(("fallback_ablation", "always_fallback", "O1_always_fallback",
                dict(mode="hybrid", skip_empty_fallback=False)))
    out += [("max_pos_sweep", mp, f"O2_max_pos={mp:<3d}",
             dict(mode="hybrid", max_pos=mp)) for mp in MAX_POS_SWEEP]
    out += [("alpha_beta_sweep", f"a{a:g}_b{b:g}",
             f"O3_alpha={a:<4g} beta={b:<4g}",
             dict(mode="hybrid", alpha=a, beta=b))
            for a, b in ALPHA_BETA_SWEEP]
    out += [("ell_topdown", tag, tag, kw) for tag, kw in ELL_TOPDOWN]
    return out


def run(scale: int = 14, edgefactor: int = 16, roots: int = 16,
        seed: int = 0, device=None, out_dir: str = "out"):
    """Every point once; returns the reference's dict of harmonic-mean
    TEPS and writes it as JSON under ``out_dir``."""
    g = rmat_graph(scale, edgefactor, seed, device=resolve_device(device))
    out = {"scale": scale, "edgefactor": edgefactor, "roots": roots,
           "device": device_name(g.device), "ladder": {},
           "max_pos_sweep": {}, "alpha_beta_sweep": {},
           "fallback_ablation": {}, "ell_topdown": {}}
    print(f"# BFS hillclimb: SCALE={scale} ef={edgefactor} roots={roots} "
          f"on {out['device']}")
    for section, key, label, knobs in points():
        v = run_graph500(scale, edgefactor, num_roots=roots, seed=seed,
                         graph=g, **knobs).harmonic_mean_teps
        out[section][key] = v
        print(f"  {label:22s} {v / 1e6:10.2f} MTEPS", flush=True)
    out["fallback_ablation"]["with_skip"] = out["ladder"]["B3_hybrid_simd"]
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"bfs_perf_s{scale}_ef{edgefactor}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {path}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--roots", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out",
                    help="directory of the JSON (default: out)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    return run(args.scale, args.edgefactor, args.roots, args.seed,
               args.device, args.out)


if __name__ == "__main__":
    main()
