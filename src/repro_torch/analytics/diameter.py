"""BFS-based diameter / eccentricity estimation (double sweep, iFUB-style;
port of ``repro.analytics.diameter``).

The classic BFS diameter recipe, run on lane batches instead of single
traversals: sweep a seed batch, take each lane's *deepest* vertex, sweep
those, repeat. Every BFS from s gives

* ``ecc(s) = max_v d(s, v)`` (within s's component) — a LOWER bound on
  that component's diameter, and
* ``2 * ecc(s)`` — an UPPER bound (any path re-routes through s).

Re-sweeping from the deepest vertex of the deepest lane is the double
sweep / iFUB descent: on trees it reaches the exact diameter in two
sweeps, and on the Graph500 small-world graphs it converges within a
couple of rounds. With a whole lane batch per round, each round refines
from ``num_seeds`` starting points for the price of one sweep.

Disconnected graphs: eccentricities are per-component (a lane only sees
its root's component). Bounds are reported for the component where the
best lower bound was found, identified by its minimum vertex id — the
same canonical id ``analytics.components`` assigns.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.analytics.engine import as_engine, pad_roots
from repro_torch.analytics.meta import QueryMeta

__all__ = ["DiameterResult", "diameter_bounds"]


@dataclass(frozen=True)
class DiameterResult:
    lower: int                   # best BFS eccentricity found
    upper: int                   # 2 * min ecc within the witness component
    component: int               # min vertex id of the witness component
    sources: np.ndarray          # int64[k] every BFS source used
    eccentricities: np.ndarray   # int64[k] ecc per source, aligned
    sweeps: int
    meta: QueryMeta = field(default_factory=QueryMeta)

    @property
    def exact(self) -> bool:
        return self.lower == self.upper


def _ecc_and_comp(depth: np.ndarray):
    """Per-lane (eccentricity, component-min-vertex, deepest vertex)."""
    reached = depth >= 0
    ecc = np.where(reached, depth, -1).max(axis=0)
    n = depth.shape[0]
    ids = np.arange(n)[:, None]
    comp = np.where(reached, ids, n).min(axis=0)     # min reached vertex
    # deepest vertex per lane, ties to the smallest id (argmax is first hit)
    deepest = np.argmax(np.where(reached, depth, -1), axis=0)
    return ecc.astype(np.int64), comp.astype(np.int64), deepest


def diameter_bounds(g_or_engine, num_seeds: int = 4, sweeps: int = 2,
                    seed: int = 0, **engine_kwargs) -> DiameterResult:
    """Bracket the diameter with ``sweeps`` lane-batch BFS rounds.

    Round 1 sweeps ``num_seeds`` random roots (degree > 0 preferred, the
    Graph500 sampling rule); each later round re-sweeps from the previous
    round's per-lane deepest vertices — the double-sweep descent. Returns
    ``lower <= diameter(component) <= upper`` for the witness component.
    """
    if num_seeds < 1 or sweeps < 1:
        raise ValueError(f"num_seeds and sweeps must be >= 1, got "
                         f"num_seeds={num_seeds} sweeps={sweeps}")
    eng = as_engine(g_or_engine, **engine_kwargs)
    n = eng.n
    rng = np.random.default_rng(seed)
    deg = eng.g.deg.cpu().numpy()
    pool = np.flatnonzero(deg > 0)
    if pool.size == 0:
        pool = np.arange(n)
    num_seeds = min(num_seeds, pool.size)
    roots = np.sort(rng.choice(pool, size=num_seeds,
                               replace=False)).astype(np.int32)

    all_src, all_ecc, all_comp = [], [], []
    layers = 0
    for rnd in range(sweeps):
        res = eng.sweep(roots)
        layers += int(res.num_layers.max())
        depth = res.depth.cpu().numpy()
        ecc, comp, deepest = _ecc_and_comp(depth)
        all_src.append(roots.astype(np.int64))
        all_ecc.append(ecc)
        all_comp.append(comp)
        nxt = pad_roots(np.unique(deepest), num_seeds)
        if rnd + 1 < sweeps and np.array_equal(np.unique(roots),
                                               np.unique(nxt)):
            break  # descent converged: re-sweeping the same set is a no-op
        roots = nxt

    src = np.concatenate(all_src)
    ecc = np.concatenate(all_ecc)
    comp = np.concatenate(all_comp)
    best = int(np.argmax(ecc))
    witness = int(comp[best])
    in_comp = comp == witness
    lower = int(ecc[best])
    upper = max(lower, 2 * int(ecc[in_comp].min()))
    return DiameterResult(
        lower=lower, upper=upper, component=witness, sources=src,
        eccentricities=ecc, sweeps=len(all_src),
        meta=QueryMeta(kind="diameter", layers=layers,
                       lanes=eng.lanes_for(num_seeds), sweeps=len(all_src),
                       ndev=eng.ndev,
                       extra=dict(num_seeds=num_seeds,
                                  requested_sweeps=sweeps)))
