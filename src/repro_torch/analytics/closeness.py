"""Closeness centrality from per-lane BFS depths (port of
``repro.analytics.closeness``).

Closeness needs distances from many sources — precisely what one MS-BFS
sweep produces as its ``depth[n, R]`` output. Two estimators share the
accumulation path:

* **exact** — every vertex is a source, swept in fixed-width chunks
  through the pipelined engine. Undirected distances are symmetric, so
  column sums over the chunks accumulate each vertex's distance total.
* **sampled** — the Eppstein–Wang style estimator over ``k`` sampled
  sources, scaled by ``n / k``. The scaling is constructed so that
  sampling ALL vertices reproduces the exact numbers bit-for-bit (the
  exact-vs-sampled agreement property of the reference).

The closeness definition is the Wasserman–Faust form (as in NetworkX),
which stays meaningful on disconnected graphs::

    c(v) = (r_v - 1)^2 / (sum_d(v) * (n - 1))

with ``r_v`` the size of v's component (reachable count including v) and
``sum_d(v)`` the sum of distances from v within its component; isolated
vertices score 0.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.analytics.engine import as_engine, pad_roots
from repro_torch.analytics.meta import QueryMeta

__all__ = ["ClosenessResult", "closeness_centrality",
           "closeness_from_depths", "closeness_from_dists",
           "select_sources"]

# auto mode: below this vertex count the exact sweep is cheap enough
EXACT_N_THRESHOLD = 2048
SAMPLED_SOURCES_DEFAULT = 256


@dataclass(frozen=True)
class ClosenessResult:
    closeness: np.ndarray        # float64[n]
    method: str                  # "exact" | "sampled"
    num_sources: int
    seed: int | None
    meta: QueryMeta = field(default_factory=QueryMeta)

    def top(self, k: int = 5) -> list[tuple[int, float]]:
        """The k most central vertices as (vertex, closeness), descending
        (ties broken by vertex id via the stable argsort)."""
        order = np.argsort(-self.closeness, kind="stable")[:k]
        return [(int(v), float(self.closeness[v])) for v in order]


def select_sources(n: int, sources,
                   seed: int) -> tuple[np.ndarray, str]:
    """The closeness source-selection rule, shared by the hop-count and
    weighted estimators (ONE implementation — the sampling scheme is part
    of the estimator's contract): ``None`` -> all n vertices (exact), an
    int -> that many distinct sampled vertices, ``"auto"`` -> exact for
    small n, a capped sample otherwise, an explicit id sequence -> used
    as-is (the serving path pins its sample this way so offline replays
    reproduce it). Returns (sources, method)."""
    if isinstance(sources, str):
        if sources != "auto":
            raise ValueError(
                f"sources must be None, 'auto', an int, or an id "
                f"sequence — got {sources!r}")
        sources = None if n <= EXACT_N_THRESHOLD else min(
            n, SAMPLED_SOURCES_DEFAULT)
    if sources is None:
        return np.arange(n, dtype=np.int32), "exact"
    if not isinstance(sources, (int, np.integer)):
        src = np.asarray(sources, np.int32).reshape(-1)
        if src.size < 1 or src.min() < 0 or src.max() >= n:
            raise ValueError(
                f"explicit closeness sources must be non-empty vertex "
                f"ids in [0, {n}), got {src!r}")
        return src, ("sampled" if src.size < n else "exact")
    k = int(sources)
    if not 1 <= k <= n:
        raise ValueError(f"sources must be in [1, {n}], got {k}")
    rng = np.random.default_rng(seed)
    src = np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)
    return src, ("sampled" if k < n else "exact")


def closeness_from_dists(dist: np.ndarray, n: int) -> np.ndarray:
    """Wasserman–Faust closeness from a float distance matrix with one
    SOURCE PER COLUMN (rows: vertices, inf unreached) — the weighted-path
    generalization the SSSP lanes feed (``analytics.weighted``); the
    hop-count form below is this with integer distances.

    With n columns (all sources) this IS the exact formula; the
    ``scale = n / k`` factor extrapolates reach counts and distance sums
    from a sample. Shared by the hop-count and weighted estimators.
    """
    dist = np.asarray(dist, np.float64)
    reached = np.isfinite(dist)
    cnt = reached.sum(axis=1)                       # sources reaching v
    sum_d = np.where(reached, dist, 0.0).sum(axis=1)
    scale = n / dist.shape[1]
    r_hat = scale * cnt                              # est. component size
    s_hat = scale * sum_d                            # est. distance sum
    out = np.zeros(dist.shape[0], np.float64)
    ok = (cnt > 0) & (s_hat > 0) & (r_hat > 1)
    out[ok] = (r_hat[ok] - 1.0) ** 2 / (s_hat[ok] * max(n - 1, 1))
    return out


def closeness_from_depths(depth: np.ndarray, n: int) -> np.ndarray:
    """Hop-count closeness: int depth matrix, -1 unreached — the BFS-lane
    instantiation of ``closeness_from_dists`` (int32 depths are exact in
    float64, so the two agree bit-for-bit on unweighted sweeps)."""
    depth = np.asarray(depth, np.int64)
    return closeness_from_dists(np.where(depth >= 0, depth, np.inf), n)


def closeness_centrality(g_or_engine, sources: int | str | None = "auto",
                         seed: int = 0, chunk: int = 256,
                         **engine_kwargs) -> ClosenessResult:
    """Closeness centrality of every vertex.

    ``sources``: ``None`` forces the exact all-sources computation,
    an int samples that many distinct source vertices, and ``"auto"``
    (default) picks exact for small graphs (n <= EXACT_N_THRESHOLD) and a
    capped sample otherwise — the small-n/large-n dispatch rule of the
    analytics API. ``chunk`` bounds roots per engine sweep; the last chunk
    is padded (ignored lanes), as the reference does.
    """
    eng = as_engine(g_or_engine, **engine_kwargs)
    n = eng.n
    src, method = select_sources(n, sources, seed)
    chunk = max(1, min(chunk, src.size))

    depth_cols = np.empty((n, src.size), np.int32)
    sweeps = 0
    layers = 0
    for lo in range(0, src.size, chunk):
        real = min(chunk, src.size - lo)
        res = eng.sweep(pad_roots(src[lo:lo + chunk], chunk))
        depth_cols[:, lo:lo + real] = res.depth[:, :real].cpu().numpy()
        layers += int(res.num_layers.max())
        sweeps += 1
    closeness = closeness_from_depths(depth_cols, n)
    return ClosenessResult(
        closeness=closeness, method=method, num_sources=int(src.size),
        seed=None if method == "exact" else seed,
        meta=QueryMeta(kind="closeness", layers=layers,
                       lanes=eng.lanes_for(chunk), sweeps=sweeps,
                       ndev=eng.ndev, extra=dict(chunk=chunk)))
