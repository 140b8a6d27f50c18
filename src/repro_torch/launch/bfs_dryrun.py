"""Dry-run of the distributed hybrid BFS on the production meshes (port of
``repro/launch/bfs_dryrun.py``): the paper's technique at datacenter scale,
Graph500 SCALE 22-26, on a fake process group of 256 or 512 ranks and meta
tensors, so that nothing is allocated and nothing is sent.

Shapes are the reference's analytic ones: n padded to a multiple of
ndev*32, each rank's edge slab 1.5x the mean (R-MAT skew headroom). One
layer of ``core/dist_bfs.py`` is traced under
``launch/roofline.py::CountingMode`` on rank 0's block: the counts
all-reduce (``_layer_counts``), then ``_topdown`` and ``_bottomup`` each,
and once the final gathers of parent and depth. The layer loop reads its
counts on the host, which a meta tensor cannot give, so the loop itself is
not run: the record gives a layer of each direction, and loop-bound totals
at ``MAX_LAYERS`` = 64 layers (the reference's convention; R-MAT diameters
are about 6-8), each layer at the larger of the two directions' counts,
metric by metric, plus the final gathers.

  PYTHONPATH=src python -m repro_torch.launch.bfs_dryrun --scale 22
      [--edgefactor 16] [--out artifacts/dryrun_torch]

writes ``bfs-graph500__scale{S}_ef{E}__{pod16x16,pod2x16x16}.json``.
"""
from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import torch

from repro_torch.core.csr import CSRGraph
from repro_torch.core.dist_bfs import (MAX_LAYERS, LocalBlock, _bottomup,
                                       _layer_counts, _topdown)
from repro_torch.core.exchange import all_gather, mesh_comm
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fake_process_group, make_production_mesh

DEFAULT_OUT = "artifacts/dryrun_torch"
MAX_POS = 8           # dist_bfs's default


def mesh_tag(mesh) -> str:
    return "pod" + "x".join(map(str, mesh.shape))


def _meta(*shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _count(fn, held) -> dict:
    with rl.CountingMode() as cm:
        cm.hold(held)
        fn()
    c = cm.collectives
    return dict(flops=cm.flops, hbm_bytes=cm.hbm_bytes,
                wire_bytes=c.wire_bytes, collective_s=c.seconds,
                num_collectives=c.count, by_op=c.by_op,
                peak_bytes=cm.peak_bytes)


def _sum(*parts) -> dict:
    out = {k: sum(p[k] for p in parts)
           for k in ("flops", "hbm_bytes", "wire_bytes", "collective_s",
                     "num_collectives")}
    by_op: dict = {}
    for p in parts:
        for op, d in p["by_op"].items():
            e = by_op.setdefault(op, dict(wire_bytes=0.0, count=0))
            e["wire_bytes"] += d["wire_bytes"]
            e["count"] += d["count"]
    out["by_op"] = by_op
    return out


def _times(part: dict, k: int) -> dict:
    out = {key: part[key] * k for key in ("flops", "hbm_bytes", "wire_bytes",
                                          "collective_s", "num_collectives")}
    out["by_op"] = {op: dict(wire_bytes=d["wire_bytes"] * k,
                             count=d["count"] * k)
                    for op, d in part["by_op"].items()}
    return out


def bfs_cell(scale: int, edgefactor: int, multi_pod: bool,
             mesh=None) -> dict:
    """One cell's record on the production mesh (or ``mesh``), over the
    process group the caller started."""
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=multi_pod)
    ndev = mesh.mesh.numel()
    n_orig = 1 << scale
    m_directed = n_orig * edgefactor * 2            # symmetrised
    block = -(-n_orig // (ndev * 32)) * 32
    n = block * ndev
    m_loc = math.ceil(m_directed / ndev * 1.5)

    comm = mesh_comm(mesh)
    blk = LocalBlock(g=CSRGraph(row_ptr=_meta(block + 1),
                                col_idx=_meta(m_loc), src_idx=_meta(m_loc)),
                     deg=_meta(block), base=comm.index * block)
    frontier = _meta(block, dtype=torch.bool)
    visited = _meta(block, dtype=torch.bool)
    parent, depth = _meta(block), _meta(block)
    held = (blk.g, blk.deg, frontier, visited, parent, depth)

    counts = _count(lambda: _layer_counts(frontier, visited, blk.deg, comm),
                    held)
    td = _count(lambda: _topdown(blk, frontier, visited, parent, n, comm),
                held)
    bu = _count(lambda: _bottomup(blk, frontier, visited, parent, MAX_POS,
                                  comm), held)
    final = _count(lambda: (all_gather(parent, comm),
                            all_gather(depth, comm)), held)
    layer = {"topdown": _sum(counts, td), "bottomup": _sum(counts, bu)}
    worst = {k: max(layer["topdown"][k], layer["bottomup"][k])
             for k in ("flops", "hbm_bytes", "wire_bytes", "collective_s",
                       "num_collectives")}
    worst["by_op"] = max(layer.values(),
                         key=lambda p: p["wire_bytes"])["by_op"]
    total = _sum(_times(worst, MAX_LAYERS), final)

    block_bytes = sum(t.numel() * t.element_size() for t in
                      (blk.g.row_ptr, blk.g.col_idx, blk.g.src_idx, blk.deg))
    state_bytes = sum(t.numel() * t.element_size()
                      for t in (frontier, visited, parent, depth))
    peak = max(p["peak_bytes"] for p in (counts, td, bu, final))
    return dict(
        kind="dist_bfs", scale=scale, edgefactor=edgefactor,
        mesh=mesh_tag(mesh), n_devices=ndev, n=n, n_orig=n_orig,
        m_loc=m_loc, n_loc=block, status="ok",
        max_pos=MAX_POS,
        loop_bound=dict(
            max_layers=MAX_LAYERS,
            rule=("totals are MAX_LAYERS layers, each at the larger of the "
                  "top-down and bottom-up layer's counts (metric by metric; "
                  "by_op from the direction with more wire bytes), plus the "
                  "final all-gathers of parent and depth")),
        flops_per_device=total["flops"],
        hbm_bytes_per_device=total["hbm_bytes"],
        collective=dict(
            wire_bytes_per_device=total["wire_bytes"],
            per_layer_wire_bytes=worst["wire_bytes"],
            per_layer_wire_bytes_by_direction={
                d: layer[d]["wire_bytes"] for d in layer},
            num_collectives=total["num_collectives"],
            by_op=total["by_op"], seconds=total["collective_s"]),
        per_layer=dict(counts=counts, topdown=td, bottomup=bu, final=final),
        memory=dict(argument_bytes=block_bytes + 4,   # + the int32 root
                    state_bytes=state_bytes, peak_live_bytes=peak,
                    temp_bytes=peak - block_bytes - state_bytes,
                    output_bytes=2 * 4 * n),
        roofline=rl.roofline_terms(total["flops"], total["hbm_bytes"],
                                   total["wire_bytes"],
                                   collective_s=total["collective_s"]),
    )


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for mp in (False, True):
        with fake_process_group(512 if mp else 256):
            rec = bfs_cell(args.scale, args.edgefactor, mp)
        tag = (f"bfs-graph500__scale{args.scale}_ef{args.edgefactor}"
               f"__{rec['mesh']}")
        (out / f"{tag}.json").write_text(json.dumps(rec, indent=2))
        t = rec["roofline"]
        print(f"[ok] {tag} peak_live={rec['memory']['peak_live_bytes'] / 1e9:.3f}GB"
              f" wire/layer={rec['collective']['per_layer_wire_bytes'] / 1e6:.1f}MB"
              f" dom={t['dominant']}", flush=True)


if __name__ == "__main__":
    main()
