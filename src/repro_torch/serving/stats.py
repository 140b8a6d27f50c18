"""Serving statistics: sojourn percentiles, per-type breakdowns, TEPS
(port of ``repro.serving.stats``, copied).

Sojourn is measured on the service's LAYER CLOCK (one engine step per
tick), not wall time — layer counts are deterministic across machines,
so p50/p99 sojourn compare across runs and devices the way TEPS does.
``answered_early`` marks requests whose answer came from the mid-sweep
streaming read-out (depth-k band final) rather than waiting for their
lane to flush; the answered-early fraction is the headline win of the
streaming surface.
"""
from __future__ import annotations

import numpy as np

from repro_torch.serving.admission import DONE, REJECTED

__all__ = ["percentile", "sojourn_summary", "summarize"]


def percentile(xs, p: float) -> float:
    """Nearest-rank percentile of a sequence (0 on empty): the smallest
    observed value with at least ``p`` percent of the sample at or below
    it — always an actual sample, never an interpolation. (Interpolated
    percentiles shift with sample size even when the observed latencies
    don't.)"""
    xs = np.sort(np.asarray(xs, np.float64))
    if xs.size == 0:
        return 0.0
    rank = int(np.ceil(p / 100.0 * xs.size))      # 1-based nearest rank
    return float(xs[min(max(rank, 1), xs.size) - 1])


def sojourn_summary(sojourns) -> dict:
    """mean/p50/p95/p99/max over a sequence of layer sojourns."""
    xs = np.asarray(sojourns, np.float64)
    if xs.size == 0:
        return dict(mean=0.0, p50=0.0, p95=0.0, p99=0.0, max=0)
    return dict(mean=round(float(xs.mean()), 2),
                p50=percentile(xs, 50), p95=percentile(xs, 95),
                p99=percentile(xs, 99), max=int(xs.max()))


def summarize(records, *, layers: int, wall_s: float, edges: int,
              lanes: int, ndev: int, occupancy=(),
              sssp_steps: int = 0, delta=None) -> dict:
    """Aggregate service stats over request records.

    Records are duck-typed: ``.kind``, ``.status``, ``.sojourn``,
    ``.answered_early``, ``.lanes_used`` (see ``service.RequestRecord``).
    """
    done = [r for r in records if r.status == DONE]
    rejected = sum(1 for r in records if r.status == REJECTED)
    sojourns = [r.sojourn for r in done]
    early = sum(1 for r in done if r.answered_early)

    per_type: dict[str, dict] = {}
    for r in done:
        per_type.setdefault(r.kind, []).append(r)
    per_type = {
        kind: dict(count=len(rs),
                   lanes=int(sum(r.lanes_used for r in rs)),
                   answered_early=sum(1 for r in rs if r.answered_early),
                   sojourn_layers=sojourn_summary([r.sojourn for r in rs]))
        for kind, rs in sorted(per_type.items())}

    occ = np.asarray(list(occupancy), np.float64)
    wall = max(float(wall_s), 1e-9)
    return dict(
        requests=len(records), done=len(done), rejected=rejected,
        layers=int(layers), wall_s=round(wall_s, 4),
        lanes=int(lanes), ndev=int(ndev),
        sojourn_layers=sojourn_summary(sojourns),
        answered_early=early,
        answered_early_frac=round(early / max(len(done), 1), 4),
        per_type=per_type,
        aggregate_mteps=round(edges / wall / 1e6, 2),
        mean_lane_occupancy=round(float(occ.mean()), 4) if occ.size else 0.0,
        sssp_steps=int(sssp_steps),
        delta=delta,
    )
