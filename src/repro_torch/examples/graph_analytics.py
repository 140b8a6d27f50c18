"""Graph analytics riding the MS-BFS lane engine, end to end (port of
``examples/graph_analytics.py``).

  python -m repro_torch.examples.graph_analytics [--device cpu]

Builds a Graph500 Kronecker graph, then answers three analytics workloads
through ONE shared ``LaneEngine`` (components, closeness, k-hop), plus
diameter bounds: every result computed by batching BFS traversals through
the packed bit-lane sweeps. The same k-hop query is then served online by
an ``AnalyticsService``, which streams it mid-sweep, bit-identical to the
offline answer.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.analytics import (ClosenessQuery, ComponentsQuery,
                                   DiameterQuery, KHopQuery, LaneEngine,
                                   run_query)
from repro_torch.device import resolve_device
from repro_torch.graph.generator import rmat_graph, sample_roots
from repro_torch.serving import AnalyticsService


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: the GPU (raises without "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = rmat_graph(10, 8, seed=0, device=dev)
    eng = LaneEngine(g, lanes=None)        # adaptive lane-pool sizing
    print(f"n={g.n:,} m={g.m:,} (scale 10, edgefactor 8)")

    comps = run_query(eng, ComponentsQuery(batch=64))
    cid, csize = comps.largest
    print(f"components: {comps.num_components} in {comps.sweeps} "
          f"sweep(s); largest = id {cid} with {csize:,} vertices "
          f"({100.0 * csize / g.n:.1f}%)")

    clo = run_query(eng, ClosenessQuery())      # auto: exact at this scale
    top = clo.top(3)
    print(f"closeness ({clo.method}, {clo.num_sources} sources): top-3 = "
          + ", ".join(f"v{v}={c:.4f}" for v, c in top))

    seeds = sample_roots(g, 4, seed=2)
    hops = run_query(eng, KHopQuery(sources=tuple(int(s) for s in seeds),
                                    k=2))
    print("2-hop neighbourhoods: " + ", ".join(
        f"|N_2({int(s)})|={int(c):,}"
        for s, c in zip(hops.sources, hops.counts)))

    diam = run_query(eng, DiameterQuery(num_seeds=4, sweeps=3, seed=3))
    print(f"diameter of component {diam.component}: "
          f"{diam.lower} <= D <= {diam.upper} "
          f"({'exact' if diam.exact else 'bracketed'} after {diam.sweeps} "
          f"sweeps)")

    # the same queries served online: AnalyticsService streams khop
    # answers mid-sweep (depth-k bands are final), bit-identical to
    # run_query above
    with AnalyticsService(g, slots=64) as svc:
        rec = svc.submit(KHopQuery(sources=tuple(int(s) for s in seeds),
                                   k=2))
        served = svc.result(rec.request.id, timeout=120.0).result
    print(f"served khop: streamed_early={rec.answered_early} "
          f"sojourn={rec.sojourn} layers")
    assert np.array_equal(served.words, hops.words)
    assert np.array_equal(served.counts, hops.counts)

    # the invariants every run must satisfy
    assert comps.sizes.sum() == g.n
    assert csize == int(np.max(comps.sizes))
    assert (clo.closeness >= 0).all() and clo.closeness.max() <= 1.0
    assert (hops.counts >= 1).all()           # a seed always reaches itself
    assert 0 <= diam.lower <= diam.upper
    print("analytics OK")
    return dict(n=g.n, m=g.m, components=int(comps.num_components),
                component_sweeps=int(comps.sweeps), largest=(int(cid),
                                                             int(csize)),
                closeness_method=clo.method,
                closeness_top=[(int(v), float(c)) for v, c in top],
                khop_counts=[int(c) for c in hops.counts],
                diameter=(int(diam.lower), int(diam.upper)),
                served_early=bool(rec.answered_early))


if __name__ == "__main__":
    main()
