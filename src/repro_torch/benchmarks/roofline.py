"""The dry-run's records as the roofline tables, one a mesh (port of
``benchmarks/roofline.py``).

Reads the JSON records of ``launch/dryrun.py`` and ``launch/bfs_dryrun.py``
(``artifacts/dryrun_torch`` under the working directory by default):

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--dir DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.bfs_dryrun import DEFAULT_OUT

MESHES = ("pod16x16", "pod2x16x16")


def load_records(mesh: str | None = "pod16x16", root=DEFAULT_OUT) -> list:
    recs = []
    for f in sorted(Path(root).glob("*.json")):
        r = json.loads(f.read_text())
        if mesh and r.get("mesh") != mesh:
            continue
        recs.append(r)
    return recs


def device_gb(r) -> float:
    """GB on one device: arguments, temporaries and outputs, less what the
    donated arguments give back (those not known count as 0)."""
    m = r.get("memory") or {}
    vals = [m.get("argument_bytes") or 0, m.get("temp_bytes") or 0,
            m.get("output_bytes") or 0]
    return (sum(vals) - (m.get("alias_bytes") or 0)) / 1e9


def _s(v) -> str:
    return "—" if v is None else f"{v:.4f}"


def markdown_table(mesh="pod16x16", root=DEFAULT_OUT) -> str:
    lines = [
        "| arch | shape | kind | GB/dev | compute_s | memory_s | "
        "collective_s | dominant | roofline frac | counted/executed flops |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in load_records(mesh, root):
        if "arch" not in r:
            continue   # bfs-graph500 cells have their own table
        head = f"| {r['arch']} | {r['shape']} | {r['kind']} |"
        if r["status"] == "error":
            lines.append(f"{head} ERROR | | | | | | |")
            continue
        if "roofline" not in r:      # a shape the reference skips
            lines.append(f"{head} — | — | — | — | skipped | — | — |")
            continue
        t = r["roofline"]
        c = r.get("counted_flops_global")
        ratio = "—" if c is None else f"{c / r['executed_flops_global']:.3f}"
        frac = t["roofline_fraction"]
        lines.append(
            f"{head} {device_gb(r):.2f} | {_s(t['compute_s'])} | "
            f"{_s(t['memory_s'])} | {_s(t['collective_s'])} | "
            f"{t['dominant'] or r['status']} | "
            f"{'—' if frac is None else f'{frac:.3f}'} | {ratio} |")
    return "\n".join(lines)


def bfs_table(mesh="pod16x16", root=DEFAULT_OUT) -> str:
    lines = ["| scale | ef | wire MB/layer (td / bu) | GB/dev peak | "
             "memory_s | collective_s | dominant |",
             "|---|---|---|---|---|---|---|"]
    for r in load_records(mesh, root):
        if r.get("kind") != "dist_bfs":
            continue
        c, t = r["collective"], r["roofline"]
        d = c["per_layer_wire_bytes_by_direction"]
        lines.append(
            f"| {r['scale']} | {r['edgefactor']} | {d['topdown'] / 1e6:.2f} "
            f"/ {d['bottomup'] / 1e6:.3f} | "
            f"{r['memory']['peak_live_bytes'] / 1e9:.3f} | "
            f"{t['memory_s']:.4f} | {t['collective_s']:.4f} | "
            f"{t['dominant']} |")
    return "\n".join(lines)


def run(root=DEFAULT_OUT) -> bool:
    for mesh in MESHES:
        print(f"\n## Roofline table — mesh {mesh}\n")
        print(markdown_table(mesh, root))
        print(f"\n## Distributed BFS — mesh {mesh}\n")
        print(bfs_table(mesh, root))
    return True


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_OUT)
    run(ap.parse_args().dir)
