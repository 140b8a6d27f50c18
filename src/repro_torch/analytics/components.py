"""Connected components as a lane-BFS forest (port of
``repro.analytics.components``).

On an undirected graph, one BFS lane reaches *exactly* its root's
component — so components fall out of the MS-BFS engine for free: seed a
batch of roots drawn from the still-unlabelled vertices, sweep, label
every vertex reached by a lane, repeat. Each sweep retires between one
component (all roots collide in one) and ``batch`` of them, so the sweep
count lands in ``[ceil(num_components / batch), num_components]`` — the
classic MS-BFS payoff of answering many traversals per sweep, with the
floor attained when every root hits a distinct component.

Labelling is canonical: roots are always the *smallest* unlabelled vertex
ids, so every component ends up labelled with its minimum vertex id
(within a batch, two roots landing in the same component merge to the
smaller root — the component-merging rule). That makes results directly
comparable to any reference labelling after the same canonicalisation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.analytics.engine import as_engine, pad_roots
from repro_torch.analytics.meta import QueryMeta

__all__ = ["ComponentsResult", "connected_components"]


@dataclass(frozen=True)
class ComponentsResult:
    labels: np.ndarray           # int64[n] — component id = min vertex id in it
    num_components: int
    component_ids: np.ndarray    # int64[C] sorted unique labels
    sizes: np.ndarray            # int64[C] vertices per component, aligned
    sweeps: int                  # engine sweeps run
    roots_used: int              # total BFS lanes consumed
    meta: QueryMeta = field(default_factory=QueryMeta)

    @property
    def largest(self) -> tuple[int, int]:
        """(component id, size) of the largest component."""
        i = int(np.argmax(self.sizes))
        return int(self.component_ids[i]), int(self.sizes[i])


def connected_components(g_or_engine, batch: int = 64,
                         **engine_kwargs) -> ComponentsResult:
    """Label every vertex with its connected component via lane-BFS sweeps.

    ``batch`` roots are seeded per sweep (padded by repeating the first
    pending root, as the reference does). Accepts a ``CSRGraph`` plus
    engine kwargs (``lanes=``, ``mode=``, ...) or a prebuilt
    ``LaneEngine``.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    eng = as_engine(g_or_engine, **engine_kwargs)
    n = eng.n
    labels = np.full(n, -1, np.int64)
    sweeps = 0
    roots_used = 0
    layers = 0
    while True:
        unlabelled = np.flatnonzero(labels < 0)
        if unlabelled.size == 0:
            break
        real = min(batch, unlabelled.size)
        roots = pad_roots(unlabelled[:real], batch)
        res = eng.sweep(roots)
        depth = res.depth.cpu().numpy()                # int32[n, batch]
        reached = depth >= 0
        # roots ascend, so the FIRST lane reaching v carries the minimum
        # root id — the in-batch merge rule
        first = np.argmax(reached, axis=1)
        hit = reached.any(axis=1) & (labels < 0)
        labels[hit] = roots[first[hit]]
        layers += int(res.num_layers.max())
        sweeps += 1
        roots_used += real
    ids, sizes = np.unique(labels, return_counts=True)
    return ComponentsResult(
        labels=labels, num_components=int(ids.size),
        component_ids=ids.astype(np.int64), sizes=sizes.astype(np.int64),
        sweeps=sweeps, roots_used=roots_used,
        meta=QueryMeta(kind="components", layers=layers,
                       lanes=eng.lanes_for(batch), sweeps=sweeps,
                       ndev=eng.ndev, extra=dict(batch=batch)))
