"""Quickstart: the paper's pipeline on the port (port of
``examples/quickstart.py``).

  python -m repro_torch.examples.quickstart [--device cpu]

1. generate a Graph500 Kronecker graph;
2. run the vectorised hybrid BFS (the port of Paredes et al.);
3. validate the BFS tree against the Graph500 rules;
4. compare against the non-SIMD baseline;
5. answer a 64-root batch in ONE sweep with the bit-packed MS-BFS;
6. stream 128 roots through the 64-lane pipelined engine: finished lanes
   refill from the pending-root queue mid-sweep.

On the GPU (the default) the traversals launch the port's CUDA kernels;
each is timed once warm, after a device sync.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.csr import to_numpy_adj
from repro_torch.core.hybrid import bfs
from repro_torch.core.msbfs import msbfs, msbfs_pipelined
from repro_torch.device import resolve_device
from repro_torch.graph.generator import rmat_graph, sample_roots
from repro_torch.graph.validate import validate_bfs_tree

SCALE, EDGEFACTOR = 13, 16


def timed(fn, dev):
    """``fn()`` once to warm up, then once timed: (result, seconds)."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print(f"generating Graph500 graph: SCALE={SCALE} "
          f"edgefactor={EDGEFACTOR}")
    g = rmat_graph(SCALE, EDGEFACTOR, seed=0, device=dev)
    print(f"  n={g.n:,} vertices, m={g.m:,} directed edges")

    root = int(sample_roots(g, 1, seed=1)[0])
    layers = {}
    for mode in ("hybrid", "hybrid_nosimd", "topdown"):
        out, dt = timed(lambda: bfs(g, root, mode), dev)
        teps = int(out.edges_traversed) / 2 / dt
        dirs = "".join("TB"[d] for d in out.trace_dir.cpu().numpy()
                       [:int(out.num_layers)])
        layers[mode] = dirs
        print(f"  {mode:15s}: {dt * 1e3:7.2f} ms  {teps / 1e6:8.1f} MTEPS  "
              f"layers={dirs}")

    rp, ci = to_numpy_adj(g)
    stats = validate_bfs_tree(rp, ci, out.parent.cpu().numpy(), root)
    print(f"BFS tree valid: {stats}")

    # --- batched MS-BFS: 64 roots, one bit-packed sweep --------------------
    roots = sample_roots(g, 64, seed=2)
    bout, dt = timed(lambda: msbfs(g, roots, "hybrid"), dev)
    edges = int(bout.edges_traversed.sum()) // 2
    print(f"  msbfs x{len(roots):2d}: {dt * 1e3:7.2f} ms  "
          f"{edges / dt / 1e6:8.1f} MTEPS aggregate "
          f"(64 traversals, one sweep)")
    r0 = int(roots[0])
    stats = validate_bfs_tree(rp, ci, bout.parent[:, 0].cpu().numpy(), r0)
    print(f"MS-BFS lane-0 tree valid: {stats}")

    # --- pipelined engine: 128 roots streamed through 64 lanes -------------
    roots = sample_roots(g, 128, seed=3)
    pout, dt = timed(lambda: msbfs_pipelined(g, roots, "hybrid"), dev)
    pedges = int(pout.edges_traversed.sum()) // 2
    print(f"  pipelined x{len(roots)}: {dt * 1e3:7.2f} ms  "
          f"{pedges / dt / 1e6:8.1f} MTEPS aggregate "
          f"(64 lanes, queue-refilled mid-sweep)")
    rl = int(roots[-1])
    stats = validate_bfs_tree(rp, ci, pout.parent[:, -1].cpu().numpy(), rl)
    print(f"pipelined last-root tree valid: {stats}")
    return dict(n=g.n, m=g.m, root=root, layers=layers, msbfs_edges=edges,
                pipelined_edges=pedges)


if __name__ == "__main__":
    main()
