"""Weighted traversal quickstart on the port: delta-stepping SSSP lanes and
weighted closeness on the semiring engine (port of
``examples/weighted_sssp.py``).

  python -m repro_torch.examples.weighted_sssp [--scale 10] [--device cpu]

Walks the whole weighted stack:
  1. generate a Graph500 Kronecker graph WITH edge weights (same topology
     as the unweighted generator; weights ride alongside);
  2. answer a batch of SSSP sources in one pipelined delta-stepping sweep
     and cross-check one source against the NumPy Dijkstra oracle;
  3. show the boolean-semiring anchor: unit weights at delta=1 reproduce
     MS-BFS depths bit for bit;
  4. run the weighted analytics queries through the shared LaneEngine.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.analytics import (LaneEngine, SSSPQuery,
                                   WeightedClosenessQuery, run_query)
from repro_torch.core.csr import from_weighted_edges
from repro_torch.core.msbfs import msbfs_pipelined
from repro_torch.device import resolve_device
from repro_torch.graph.generator import rmat_weighted_graph, sample_roots
from repro_torch.traversal import (default_delta, dijkstra_reference,
                                   sssp_pipelined, to_numpy_weighted)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--edgefactor", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. weighted Kronecker graph (weights uniform in (0, 1], symmetric)
    wg = rmat_weighted_graph(args.scale, args.edgefactor, args.seed,
                             device=dev)
    print(f"graph: n={wg.n} m={wg.m} "
          f"w in [{float(wg.weights.min()):.3f}, "
          f"{float(wg.weights.max()):.3f}] "
          f"default delta={default_delta(wg):.4f}")

    # 2. one pipelined sweep answers many sources (lanes < R: the
    #    pending-source queue streams them through the pool)
    roots = sample_roots(wg, 8, seed=1)
    res = sssp_pipelined(wg, roots, lanes=4)
    reached, steps = [], []
    for i, r in enumerate(roots[:3]):
        d = res.dist[:, i].cpu().numpy()
        fin = np.isfinite(d)
        reached.append(int(fin.sum()))
        steps.append(int(res.steps[i]))
        print(f"source {int(r):6d}: reached {reached[-1]} vertices, "
              f"max dist {d[fin].max():.3f}, engine steps {steps[-1]}")
    ref = dijkstra_reference(*to_numpy_weighted(wg), int(roots[0]))
    ok = np.allclose(res.dist[:, 0].cpu().numpy()[np.isfinite(ref)],
                     ref[np.isfinite(ref)], atol=1e-4)
    print(f"lane 0 == Dijkstra oracle: {ok}")

    # 3. the boolean-semiring anchor: unit weights, delta=1 -> BFS depths
    src, dst = wg.src_idx.cpu().numpy(), wg.col_idx.cpu().numpy()
    unit = from_weighted_edges(src, dst, np.ones(wg.m), wg.n,
                               symmetrize=False, drop_self_loops=False,
                               device=dev)
    sres = sssp_pipelined(unit, roots, delta=1.0, lanes=4)
    mres = msbfs_pipelined(unit.csr, roots, lanes=32)
    same = bool(torch.equal(sres.as_depth(), mres.depth))
    print(f"unit-weight SSSP bit-identical to MS-BFS depths: {same}")

    # 4. weighted analytics through the shared engine facade
    eng = LaneEngine(wg)
    q = run_query(eng, SSSPQuery(sources=tuple(int(r) for r in roots[:4])))
    print(f"SSSPQuery: {q.dist.shape[1]} sources, delta={q.delta:.4f}")
    wc = run_query(eng, WeightedClosenessQuery())
    top = int(np.argmax(wc.closeness))
    print(f"WeightedClosenessQuery ({wc.method}, {wc.num_sources} "
          f"sources): top vertex {top} "
          f"closeness {wc.closeness[top]:.4f}")
    return dict(n=wg.n, m=wg.m, delta=float(default_delta(wg)),
                reached=reached, steps=steps, dijkstra_ok=bool(ok),
                unit_anchor=same, query_sources=int(q.dist.shape[1]),
                wcloseness_method=wc.method,
                wcloseness_sources=int(wc.num_sources), wcloseness_top=top)


if __name__ == "__main__":
    main()
