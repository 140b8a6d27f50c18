"""Workload traces for the analytics service (port of
``repro.serving.trace``, copied: the same arguments give the reference's
trace, element for element).

A trace is just a list of ``AnalyticsRequest`` envelopes ordered by
``arrival`` (layer-clock ticks). ``parse_mix`` turns a ``"bfs:4,khop:2"``
spec into weights — validated against the ONE tag registry
(``analytics.api.QUERY_KINDS``), so the CLI, the bench, and wire
deserialization share a single unknown-tag error path. ``synthetic_trace``
builds a deterministic mixed-workload trace from those weights: bursts of
``burst`` requests arriving every ``every`` layers, tenants assigned
round-robin — the replayed-trace input of the serve bench and the
admission tests.
"""
from __future__ import annotations

import numpy as np

from repro_torch.analytics.api import (AnalyticsRequest, BFSQuery,
                                       ClosenessQuery, ComponentsQuery,
                                       DiameterQuery, KHopQuery, QUERY_KINDS,
                                       ReachQuery, SSSPQuery,
                                       WeightedClosenessQuery)

__all__ = ["parse_mix", "synthetic_trace"]


def parse_mix(spec: str) -> dict[str, float]:
    """``"bfs:4,khop:2,reach:1"`` -> normalized weights by tag.

    Tags are validated against ``QUERY_KINDS`` — the same registry the
    envelope codec uses, so a typo fails here with the same vocabulary
    instead of surfacing later as a missing handler."""
    weights: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, w = part.partition(":")
        kind = kind.strip()
        if kind not in QUERY_KINDS:        # the ONE unknown-tag error path
            raise ValueError(
                f"unknown query tag {kind!r} — expected one of "
                f"{sorted(QUERY_KINDS)}")
        try:
            weight = float(w) if w else 1.0
        except ValueError:
            raise ValueError(
                f"bad weight {w!r} for tag {kind!r} in mix {spec!r}")
        if weight < 0:
            raise ValueError(f"negative weight for tag {kind!r}")
        weights[kind] = weights.get(kind, 0.0) + weight
    total = sum(weights.values())
    if total <= 0:
        raise ValueError(f"empty workload mix {spec!r}")
    return {k: v / total for k, v in weights.items()}


def _make_query(kind: str, rng, n: int, *, khop_k: int,
                closeness_sources: int, delta):
    root = int(rng.integers(n))
    if kind == "bfs":
        return BFSQuery(sources=(root,))
    if kind == "khop":
        return KHopQuery(sources=(root,), k=khop_k)
    if kind == "reach":
        return ReachQuery(sources=(root,), targets=(int(rng.integers(n)),))
    if kind == "closeness":
        k = min(closeness_sources, n)
        src = np.sort(rng.choice(n, size=k, replace=False))
        return ClosenessQuery(sources=tuple(int(v) for v in src),
                              chunk=k)
    if kind == "sssp":
        return SSSPQuery(sources=(root,), delta=delta)
    if kind == "components":
        return ComponentsQuery()
    if kind == "diameter":
        return DiameterQuery(seed=int(rng.integers(1 << 30)))
    if kind == "weighted_closeness":
        return WeightedClosenessQuery(sources=min(closeness_sources, n),
                                      seed=int(rng.integers(1 << 30)),
                                      delta=delta)
    raise ValueError(f"unknown query tag {kind!r} — expected one of "
                     f"{sorted(QUERY_KINDS)}")


def synthetic_trace(n: int, num: int, mix: str = "bfs", seed: int = 0,
                    *, khop_k: int = 2, closeness_sources: int = 8,
                    delta=None, burst: int = 4, every: int = 2,
                    tenants: tuple[str, ...] = ("default",)
                    ) -> list[AnalyticsRequest]:
    """Deterministic mixed-workload trace over an ``n``-vertex graph.

    Request ``i`` arrives at layer ``(i // burst) * every`` with tenant
    ``tenants[i % len(tenants)]``; kinds are drawn from the normalized
    ``mix`` weights. Same (n, num, mix, seed, knobs) -> bit-identical
    trace, which is what makes replay benches and parity tests stable.
    """
    if num < 1:
        raise ValueError(f"num must be >= 1, got {num}")
    weights = parse_mix(mix)
    kinds = sorted(weights)
    probs = np.asarray([weights[k] for k in kinds], np.float64)
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(kinds), size=num, p=probs)
    trace = []
    for i, pick in enumerate(picks):
        q = _make_query(kinds[int(pick)], rng, n, khop_k=khop_k,
                        closeness_sources=closeness_sources, delta=delta)
        trace.append(AnalyticsRequest(
            query=q, tenant=tenants[i % len(tenants)],
            arrival=(i // burst) * every))
    return trace
