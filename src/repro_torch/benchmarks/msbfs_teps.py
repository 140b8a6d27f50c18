"""MS-BFS aggregate TEPS: the pipelined multi-root sweep against the serial
loop, on the GPU (port of ``benchmarks/msbfs_teps.py``).

The serial harness runs one hybrid BFS per root; the batched harness
streams all roots through the pipelined bit-lane engine
(``repro_torch.core.msbfs``) in one sweep. The headline is aggregate TEPS,
total traversed edges over total wall time: throughput under an R-root
batch.

Default is the curve R in {64, 128, 256} against the serial baseline at
R = 64; ``--roots N`` runs one serial/batched pair at N.

  python -m repro_torch.benchmarks.msbfs_teps --scale 20
  python -m repro_torch.benchmarks.msbfs_teps --scale 20 --roots 64

(with ``src`` on ``PYTHONPATH``). Each run prints its card and the
summaries; ``--json PATH`` also writes them to PATH.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.device import device_name, resolve_device
from repro_torch.graph.generator import rmat_graph
from repro_torch.graph.graph500 import run_graph500

CURVE_ROOTS = (64, 128, 256)


def _print_result(label, res):
    s = res.summary()
    print(f"  {label:14s}: aggregate {s['aggregate_teps'] / 1e6:10.2f} "
          f"MTEPS  (harmonic-mean per-root "
          f"{s['harmonic_mean_teps'] / 1e6:10.2f} MTEPS, "
          f"total time {sum(res.times):.4f}s, {s['nroots']} roots)",
          flush=True)


def run(scale: int = 14, edgefactor: int = 16, roots_curve=CURVE_ROOTS,
        mode: str = "hybrid", seed: int = 0, validate: bool = False,
        lanes: int = 64, device=None) -> dict:
    """The serial baseline at ``roots_curve[0]`` roots, then one batched
    sweep per root count. Returns the summaries by label."""
    dev = resolve_device(device)
    g = rmat_graph(scale, edgefactor, seed, device=dev)
    print(f"# MS-BFS aggregate TEPS on {device_name(dev)}: scale={scale} "
          f"ef={edgefactor} mode={mode} lanes={lanes} "
          f"R={list(roots_curve)}")
    print(f"  n={g.n:,} vertices, m={g.m:,} directed edge slots")
    base = run_graph500(scale, edgefactor, mode=mode,
                        num_roots=roots_curve[0], seed=seed, graph=g,
                        validate=validate)
    _print_result(f"serial R={roots_curve[0]}", base)
    out = {f"serial R={roots_curve[0]}": base.summary()}
    for r in roots_curve:
        res = run_graph500(scale, edgefactor, mode=mode, num_roots=r,
                           seed=seed, graph=g, validate=validate,
                           batched=True, lanes=lanes)
        _print_result(f"batched R={r}", res)
        speedup = res.aggregate_teps / max(base.aggregate_teps, 1e-12)
        print(f"    -> {speedup:6.2f}x the R={roots_curve[0]} serial "
              f"aggregate TEPS", flush=True)
        out[f"batched R={r}"] = dict(res.summary(), speedup=speedup)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=14)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--roots", type=int, default=None,
                    help="one serial/batched pair at this root count; "
                         "default runs the R=64/128/256 curve")
    ap.add_argument("--lanes", type=int, default=64,
                    help="bit-lane pool of the pipelined engine")
    ap.add_argument("--mode", default="hybrid",
                    choices=("hybrid", "topdown", "bottomup_simd"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--validate", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    ap.add_argument("--json", default=None, help="also write the summaries")
    args = ap.parse_args(argv)
    curve = CURVE_ROOTS if args.roots is None else (args.roots,)
    out = run(args.scale, args.edgefactor, curve, args.mode, args.seed,
              args.validate, args.lanes, args.device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
