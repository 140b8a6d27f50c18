"""Traversal read-out workloads: BFS depths, k-hop bands, reachability
(port of ``repro.analytics.khop``).

A k-hop query is a depth-sliced BFS read-out: run the lane engine from the
query sources, then slice the per-lane depths at ``depth <= k``. The result
keeps the engines' own bit layout (``core.packed.depth_slice_words``: bit
``r % LANE_WORD_BITS`` of lane word ``r // LANE_WORD_BITS``), viewed as host
unsigned words (``uint32`` or ``uint64``, the reference's dtype), so that
downstream packed consumers work on words; per-lane membership unpacks on
demand.

``bfs_depths`` / ``reach_hops`` are the plain-traversal siblings behind
``BFSQuery`` / ``ReachQuery``: full per-source depth columns and pairwise
hop distances. Each workload copies the sweep's depths to the host once.

``graph/sampler.py`` exposes the k-hop band as ``khop_node_sets``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analytics.engine import as_engine
from repro_torch.analytics.meta import QueryMeta
from repro_torch.core.packed import (depth_slice_words, host_word_dtype,
                                     signed_words, unpack_lanes)

__all__ = ["BFSResult", "KHopResult", "ReachResult", "bfs_depths",
           "khop_neighborhood", "reach_hops", "reachability"]


@dataclass(frozen=True)
class KHopResult:
    sources: np.ndarray          # int32[S]
    k: int
    words: np.ndarray            # uint32/64[n, W] — packed membership, lane s = source s
    counts: np.ndarray           # int64[S] — |k-hop neighbourhood| incl. source
    depth: np.ndarray            # int32[n, S] — BFS depths (-1 unreached)
    meta: QueryMeta = field(default_factory=QueryMeta)

    def members(self, lane: int) -> np.ndarray:
        """Vertex ids within k hops of ``sources[lane]`` (ascending)."""
        d = self.depth[:, lane]
        return np.flatnonzero((d >= 0) & (d <= self.k))

    def member_mask(self) -> np.ndarray:
        """bool[n, S] unpacked membership (one column per source)."""
        words = torch.from_numpy(signed_words(self.words))
        return unpack_lanes(words, self.sources.size).numpy()


@dataclass(frozen=True)
class BFSResult:
    """Full traversal read-out per source: depth columns + reach counts."""
    sources: np.ndarray          # int32[S]
    depth: np.ndarray            # int32[n, S] — BFS depths, -1 unreached
    num_layers: np.ndarray       # int64[S] — layers until the frontier emptied
    reached: np.ndarray          # int64[S] — vertices reached incl. source
    meta: QueryMeta = field(default_factory=QueryMeta)


@dataclass(frozen=True)
class ReachResult:
    """Pairwise source->target hop distances (-1 unreachable)."""
    sources: np.ndarray          # int32[S]
    targets: np.ndarray          # int32[T]
    hops: np.ndarray             # int64[S, T]
    meta: QueryMeta = field(default_factory=QueryMeta)

    def reachable(self) -> np.ndarray:
        """bool[S, T] — target reachable from source."""
        return self.hops >= 0


def khop_result_from_depth(sources: np.ndarray, k: int, depth,
                           meta: QueryMeta) -> KHopResult:
    """Assemble a ``KHopResult`` from depth columns whose ``<= k`` band is
    final (words, counts and members read only the band). ``depth`` is a
    host array or the sweep's tensor: the words are packed where it lies,
    so a sweep on the card copies its depths to the host once, and no
    [n, 32 W] int64 packing intermediate is built on the host."""
    depth = torch.as_tensor(depth)
    counts = ((depth >= 0) & (depth <= k)).sum(dim=0)
    words = depth_slice_words(depth, k).cpu().numpy()
    return KHopResult(sources=sources, k=int(k),
                      words=words.view(host_word_dtype()),
                      counts=counts.cpu().numpy(), depth=depth.cpu().numpy(),
                      meta=meta)


def _sweep_depths(eng, sources):
    """One sweep: host int32 depths [n, S] and per-lane layers int32[S]."""
    res = eng.sweep(sources)
    return res.depth.cpu().numpy(), res.num_layers.cpu().numpy()


def khop_neighborhood(g_or_engine, sources, k: int,
                      **engine_kwargs) -> KHopResult:
    """All vertices within ``k`` hops of each source, one engine sweep
    (sources share the sweep as bit lanes)."""
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    eng = as_engine(g_or_engine, **engine_kwargs)
    sources = np.asarray(sources, np.int32).reshape(-1)
    res = eng.sweep(sources)
    meta = QueryMeta(kind="khop", layers=int(res.num_layers.max()),
                     lanes=eng.lanes_for(sources.size), ndev=eng.ndev)
    return khop_result_from_depth(sources, k, res.depth, meta)


def bfs_depths(g_or_engine, sources, **engine_kwargs) -> BFSResult:
    """Full BFS from each source — the ``BFSQuery`` handler: one engine
    sweep, depth columns plus per-source layer/reach counts."""
    eng = as_engine(g_or_engine, **engine_kwargs)
    sources = np.asarray(sources, np.int32).reshape(-1)
    depth, num_layers = _sweep_depths(eng, sources)
    num_layers = num_layers.astype(np.int64)
    return BFSResult(
        sources=sources, depth=depth, num_layers=num_layers,
        reached=(depth >= 0).sum(axis=0).astype(np.int64),
        meta=QueryMeta(kind="bfs", layers=int(num_layers.max()),
                       lanes=eng.lanes_for(sources.size), ndev=eng.ndev))


def reach_hops(g_or_engine, sources, targets=None,
               **engine_kwargs) -> ReachResult:
    """Pairwise hop distances between source and target batches — the
    ``ReachQuery`` handler. ``targets=None`` uses the sources
    (all-pairs)."""
    eng = as_engine(g_or_engine, **engine_kwargs)
    sources = np.asarray(sources, np.int32).reshape(-1)
    targets = sources if targets is None else np.asarray(
        targets, np.int32).reshape(-1)
    depth, num_layers = _sweep_depths(eng, sources)
    return ReachResult(
        sources=sources, targets=targets,
        hops=depth[targets].T.astype(np.int64),
        meta=QueryMeta(kind="reach", layers=int(num_layers.max()),
                       lanes=eng.lanes_for(sources.size), ndev=eng.ndev))


def reachability(g_or_engine, sources, targets=None,
                 **engine_kwargs) -> np.ndarray:
    """Pairwise hop distances ``int64[S, T]`` between source and target
    batches (-1 unreachable); ``reach_hops`` returns the typed
    envelope."""
    return reach_hops(g_or_engine, sources, targets, **engine_kwargs).hops
