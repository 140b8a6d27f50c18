"""Benchmark runner on the GPU, one function per paper table or figure
(port of ``benchmarks/run.py``).

Prints ``name,us_per_call,derived`` CSV for each benchmark, where
``us_per_call`` is the wall time of the benchmark's run (graph generation
included, as in the reference) and ``derived`` the benchmark's headline
derived quantity.

  python -m repro_torch.benchmarks.run            # fast defaults
  python -m repro_torch.benchmarks.run --full     # paper-scale sweep

(with ``src`` on ``PYTHONPATH``; ``--device cpu`` for the plain PyTorch
path). The fifth bench, ``roofline``, runs nothing on a device: it reads
the dry-run's records (``launch/dryrun.py``, ``launch/bfs_dryrun.py``,
under ``artifacts/dryrun_torch``) and reports the 16x16 mesh's cells with
all three roofline terms and a compute term, and the best roofline
fraction among them (``cells=0`` when there are none; a BFS cell counts
no FLOPs, and a GNN cell whose step builds its adjacency from the edges is
skipped).
"""
from __future__ import annotations

import argparse
import time

from repro_torch.device import resolve_device


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e6


def bench_table2(full: bool, device):
    from repro_torch.benchmarks.table2_switching import run
    rows, us = _timed(run, 14 if full else 11, 16, device=device)
    bu_layers = sum(1 for r in rows if r["approach"] == "bottom-up")
    return us, f"bu_layers={bu_layers}/{len(rows)}"


def bench_table3(full: bool, device):
    from repro_torch.benchmarks.table3_maxpos import run
    rows, us = _timed(run, 13 if full else 11, 16, device=device)
    big = max(rows, key=lambda r: r["found"])
    return us, f"retired@8={big['retired_frac'][8]:.3f}"


def bench_fig3(full: bool, device):
    from repro_torch.benchmarks.fig3_teps import run
    scales = (12, 13, 14) if full else (10, 11)
    efs = (16, 32, 64) if full else (16, 32)
    res, us = _timed(run, scales, efs, 16 if full else 4, device=device)
    sc = scales[-1]
    simd = res[(sc, efs[-1], "hybrid")]
    nosimd = res[(sc, efs[-1], "hybrid_nosimd")]
    return us, f"simd_vs_nosimd={simd / max(nosimd, 1):.3f}x"


def bench_table4(full: bool, device):
    from repro_torch.benchmarks.table4_counters import run
    rows, us = _timed(run, 13 if full else 11, 32 if full else 16,
                      device=device)
    tot_no = sum(r["t_nosimd_ms"] for r in rows)
    tot_si = sum(r["t_simd_ms"] for r in rows)
    return us, f"bu_speedup={tot_no / max(tot_si, 1e-9):.2f}x"


def bench_roofline(full: bool, device):
    from repro_torch.benchmarks.roofline import load_records
    recs, us = _timed(load_records, "pod16x16")
    # a record with no compute term (a BFS cell: the counting mode prices
    # products, and a BFS layer has none) has no roofline fraction to rank
    ok = [r for r in recs if r["status"] == "ok" and "roofline" in r
          and r["roofline"]["compute_s"]]
    if not ok:
        return us, "cells=0"
    best = max(ok, key=lambda r: r["roofline"]["roofline_fraction"])
    return us, (f"cells={len(ok)};best_frac="
                f"{best['roofline']['roofline_fraction']:.3f}"
                f"@{best.get('arch', 'bfs')}/{best.get('shape', '')}")


BENCHES = [
    ("table2_switching", bench_table2),
    ("table3_maxpos", bench_table3),
    ("fig3_teps", bench_fig3),
    ("table4_counters", bench_table4),
    ("roofline", bench_roofline),
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="paper-scale sweep (slower)")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without one)")
    args = ap.parse_args(argv)
    names = [name for name, _ in BENCHES]
    if args.only is not None and args.only not in names:
        ap.error(f"--only must be one of {names}")
    # the roofline bench reads records and needs no device
    device = None if args.only == "roofline" else resolve_device(args.device)

    print("name,us_per_call,derived")
    for name, fn in BENCHES:
        if args.only and args.only != name:
            continue
        us, derived = fn(args.full, device)
        print(f"{name},{us:.0f},{derived}", flush=True)


if __name__ == "__main__":
    main()
