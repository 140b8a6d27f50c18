"""Lane-parallel graph analytics on the MS-BFS engine (port of
``repro.analytics``).

Connected components, closeness centrality, BFS / k-hop neighbourhood /
reachability queries and diameter bounds, all computed by batching
traversals through the bit-lane engine (``core.msbfs``): many analytics
traversals per packed sweep. Engines built from a ``WeightedCSRGraph`` also
serve the weighted workloads (``SSSPQuery``, ``WeightedClosenessQuery``) on
the delta-stepping lanes of ``traversal.sssp``.

Build queries from ``api`` (``ComponentsQuery``, ...) and dispatch with
``run_query``, or call the workload functions directly. Share one
``LaneEngine`` across queries. Every result carries the uniform
``QueryMeta``. Results are host numpy dataclasses with the reference's
dtypes; the sweeps run on the graph's device.
"""
from repro_torch.analytics.api import (AnalyticsAnswer, AnalyticsRequest,
                                       BFSQuery, ClosenessQuery,
                                       ComponentsQuery, DiameterQuery,
                                       KHopQuery, QUERY_KINDS, QUERY_TYPES,
                                       ReachQuery, SSSPQuery,
                                       WeightedClosenessQuery,
                                       answer_request, query_kind,
                                       run_query)
from repro_torch.analytics.closeness import (ClosenessResult,
                                             closeness_centrality,
                                             closeness_from_depths,
                                             closeness_from_dists)
from repro_torch.analytics.components import (ComponentsResult,
                                              connected_components)
from repro_torch.analytics.diameter import DiameterResult, diameter_bounds
from repro_torch.analytics.engine import LaneEngine, as_engine
from repro_torch.analytics.khop import (BFSResult, KHopResult, ReachResult,
                                        bfs_depths, khop_neighborhood,
                                        reach_hops, reachability)
from repro_torch.analytics.meta import QueryMeta
from repro_torch.analytics.weighted import (SSSPDistancesResult,
                                            sssp_distances,
                                            weighted_closeness_centrality)

__all__ = [
    "AnalyticsAnswer", "AnalyticsRequest", "BFSQuery", "BFSResult",
    "ClosenessQuery", "ClosenessResult", "ComponentsQuery",
    "ComponentsResult", "DiameterQuery", "DiameterResult", "KHopQuery",
    "KHopResult", "LaneEngine", "QUERY_KINDS", "QUERY_TYPES", "QueryMeta",
    "ReachQuery", "ReachResult", "SSSPDistancesResult", "SSSPQuery",
    "WeightedClosenessQuery", "answer_request", "as_engine", "bfs_depths",
    "closeness_centrality", "closeness_from_depths", "closeness_from_dists",
    "connected_components", "diameter_bounds", "khop_neighborhood",
    "query_kind", "reach_hops", "reachability", "run_query",
    "sssp_distances", "weighted_closeness_centrality",
]
