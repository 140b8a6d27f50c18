"""Exact k-hop candidate pools for neighbour sampling (port of
``khop_node_sets`` from ``repro.graph.sampler``; the fanout sampler waits
for its first user)."""
from __future__ import annotations

from repro_torch.analytics.khop import khop_neighborhood


def khop_node_sets(g, seeds, k: int, **engine_kwargs):
    """Each seed's complete depth <= k neighbourhood, from ONE lane sweep
    of the packed MS-BFS engine (``analytics.khop``).

    Returns ``(node_sets, khop_result)``: ``node_sets[i]`` is the
    ascending int64 vertex-id array within ``k`` hops of ``seeds[i]``
    (seed included); ``khop_result`` keeps the packed words, counts and
    depths. ``engine_kwargs`` pass through to the analytics
    ``LaneEngine`` (``lanes=``, ...).
    """
    res = khop_neighborhood(g, seeds, k, **engine_kwargs)
    sets = [res.members(i) for i in range(res.sources.size)]
    return sets, res
