"""Weighted analytics workloads on the tropical (SSSP) lane engine (port
of ``repro.analytics.weighted``).

The unweighted workloads read per-lane BFS *depths*; these read per-lane
shortest-path *distances* from the delta-stepping engine
(``traversal.sssp``) through the same ``LaneEngine`` facade:

* ``sssp_distances`` — batched single-source shortest paths: one dense
  tropical lane per source, sources beyond the lane pool streamed
  through the pending queue;
* ``weighted_closeness_centrality`` — Wasserman–Faust closeness over
  weighted distances, exact chunked all-sources or the sampled
  Eppstein–Wang style estimator — the SAME accumulation/estimator code
  as the unweighted version (``closeness_from_dists``), so sampling all
  vertices again reduces exactly to the exact numbers.

Engines must be built from a ``WeightedCSRGraph``; the boolean workloads
keep working on the same engine (weights ignored).
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import numpy as np

from repro_torch.analytics.closeness import (ClosenessResult,
                                             closeness_from_dists,
                                             select_sources)
from repro_torch.analytics.engine import as_engine, pad_roots
from repro_torch.analytics.meta import QueryMeta
from repro_torch.traversal.sssp import adaptive_delta, default_delta

__all__ = ["SSSPDistancesResult", "sssp_distances",
           "weighted_closeness_centrality"]


@dataclass(frozen=True)
class SSSPDistancesResult:
    sources: np.ndarray          # int32[S]
    dist: np.ndarray             # float32[n, S], inf unreached
    delta: float | tuple         # bucket width(s) the sweep ran with
    steps: np.ndarray            # int32[S] engine steps per source lane
    truncated_lanes: np.ndarray  # bool[S] — lane hit the step cap: its
    #                              column is a partial relaxation
    meta: QueryMeta = field(default_factory=QueryMeta)

    @property
    def truncated(self) -> np.ndarray:
        """Deprecated spelling of ``truncated_lanes`` (the common
        ``meta.truncated`` flag is now the any-lane summary)."""
        warnings.warn(
            "SSSPDistancesResult.truncated is deprecated — use "
            ".truncated_lanes (per-lane) or .meta.truncated (any lane)",
            DeprecationWarning, stacklevel=2)
        return self.truncated_lanes

    def reached(self) -> np.ndarray:
        """bool[n, S] — vertices with a finite distance per source."""
        return np.isfinite(self.dist)

    def distances_to(self, targets) -> np.ndarray:
        """float64[S, T] pairwise source->target distances (inf
        unreachable) — the weighted analog of ``khop.reachability``."""
        targets = np.asarray(targets, np.int64).reshape(-1)
        return np.asarray(self.dist, np.float64)[targets].T


def _resolve_delta(eng, delta) -> float | tuple | None:
    """Pin ``delta=None`` to the graph default ONCE per workload call —
    the engine would otherwise recompute it (a host copy of all m
    weights) inside every chunk sweep, and the recorded metadata would
    not name the width actually used. ``delta="adaptive"`` runs the
    weight-histogram rule (``traversal.sssp.adaptive_delta``): on bimodal
    weights it widens the bucket past the light/heavy gap — fewer settle
    steps, identical distances (any positive width is exact at fixpoint).
    A scalar or per-lane tuple passes through unchanged."""
    if not eng.weighted:
        return delta              # unweighted: let sssp_sweep raise
    if delta is None:
        return float(default_delta(eng.wg))
    if isinstance(delta, str):
        if delta != "adaptive":
            raise ValueError(
                f"delta must be None, 'adaptive', a scalar, or a "
                f"per-lane tuple — got {delta!r}")
        return float(adaptive_delta(eng.wg))
    return delta


def sssp_distances(g_or_engine, sources, delta=None,
                   **engine_kwargs) -> SSSPDistancesResult:
    """Shortest-path distances from each source, one pipelined
    delta-stepping sweep on whatever partition the engine was built with
    (host, 1-D mesh or 2-D grid; the distances are the same).
    ``delta=None`` picks the engine default
    (``traversal.sssp.default_delta``); ``delta="adaptive"`` the
    weight-histogram width; a per-lane tuple hands each lane its own."""
    eng = as_engine(g_or_engine, **engine_kwargs)
    delta = _resolve_delta(eng, delta)
    sources = np.asarray(sources, np.int32).reshape(-1)
    res = eng.sssp_sweep(sources, delta=delta)
    steps = res.steps.cpu().numpy()
    truncated_lanes = res.truncated.cpu().numpy()
    return SSSPDistancesResult(
        sources=sources, dist=res.dist.cpu().numpy(),
        delta=delta if isinstance(delta, tuple) else float(delta),
        steps=steps, truncated_lanes=truncated_lanes,
        meta=QueryMeta(kind="sssp", layers=int(steps.max()),
                       truncated=bool(truncated_lanes.any()),
                       lanes=eng.sssp_lanes_for(sources.size),
                       ndev=eng.ndev,
                       extra=dict(grid=eng.grid, compress=eng.compress,
                                  delta=delta)))


def weighted_closeness_centrality(g_or_engine,
                                  sources: int | str | None = "auto",
                                  seed: int = 0, chunk: int = 64,
                                  delta=None,
                                  **engine_kwargs) -> ClosenessResult:
    """Weighted closeness centrality of every vertex — the unweighted
    estimator with SSSP distances standing in for BFS depths.

    ``sources`` follows the same rule: ``None`` forces exact
    all-sources, an int samples that many, ``"auto"`` dispatches on n.
    ``chunk`` bounds sources per engine sweep (dense float lanes — the
    default is narrower than the packed-lane chunk).
    """
    eng = as_engine(g_or_engine, **engine_kwargs)
    delta = _resolve_delta(eng, delta)
    n = eng.n
    src, method = select_sources(n, sources, seed)
    chunk = max(1, min(chunk, src.size))

    dist_cols = np.empty((n, src.size), np.float32)
    sweeps = 0
    steps = 0
    truncated = 0
    for lo in range(0, src.size, chunk):
        real = min(chunk, src.size - lo)
        res = eng.sssp_sweep(pad_roots(src[lo:lo + chunk], chunk),
                             delta=delta)
        dist_cols[:, lo:lo + real] = res.dist[:, :real].cpu().numpy()
        truncated += int(res.truncated[:real].sum())
        steps += int(res.steps.max())
        sweeps += 1
    closeness = closeness_from_dists(dist_cols, n)
    return ClosenessResult(
        closeness=closeness, method=method, num_sources=int(src.size),
        seed=None if method == "exact" else seed,
        meta=QueryMeta(kind="weighted_closeness", layers=steps,
                       truncated=truncated > 0,
                       lanes=eng.sssp_lanes_for(chunk), sweeps=sweeps,
                       ndev=eng.ndev,
                       extra=dict(chunk=chunk, weighted=True, delta=delta,
                                  truncated_lanes=truncated)))
