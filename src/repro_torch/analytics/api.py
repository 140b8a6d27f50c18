"""Typed query surface of the analytics layer (port of
``repro.analytics.api``).

One dataclass per workload, one dispatcher, one request/answer envelope.
Callers build a query value, hand it to ``run_query`` with a graph (or a
prebuilt ``LaneEngine``), and get the workload's typed result back::

    from repro_torch.analytics import (ComponentsQuery, KHopQuery,
                                       LaneEngine, run_query)

    eng = LaneEngine(g, lanes=None)               # adaptive pool
    comps = run_query(eng, ComponentsQuery())
    hops = run_query(eng, KHopQuery(sources=(3, 17, 42), k=2))

The lane-pool sizing (``lanes=None`` -> ``packed.adaptive_lane_pool``)
lives in ``LaneEngine``; queries stay pure descriptions.

**Tags.** Every query class declares its wire tag as an explicit ``kind``
ClassVar, surfaced through ``query_kind`` and collected into the
``QUERY_KINDS`` registry at import time, with validation, so a query type
that forgets (or typos) its tag fails the import. ``QUERY_KINDS`` is the
single source of truth for ``from_wire``.

**Envelope.** ``AnalyticsRequest(id, tenant, query, arrival)`` /
``AnalyticsAnswer(id, result, meta)`` wrap queries for serving;
``answer_request`` is the offline handler, routed through the same
per-type handler table (``_HANDLERS``) as ``run_query``.

**Wire.** ``result_to_wire`` ships every array as raw little-endian bytes
with its dtype tag, so a result encodes to the same JSON as the
reference's when the arrays and metadata are equal.
"""
from __future__ import annotations

import base64
import itertools
from dataclasses import asdict, dataclass, field, fields
from typing import ClassVar

import numpy as np

from repro_torch.analytics.closeness import (ClosenessResult,
                                             closeness_centrality)
from repro_torch.analytics.components import (ComponentsResult,
                                              connected_components)
from repro_torch.analytics.diameter import DiameterResult, diameter_bounds
from repro_torch.analytics.engine import as_engine
from repro_torch.analytics.khop import (BFSResult, KHopResult, ReachResult,
                                        bfs_depths, khop_neighborhood,
                                        reach_hops)
from repro_torch.analytics.meta import QueryMeta
from repro_torch.analytics.weighted import (SSSPDistancesResult,
                                            sssp_distances,
                                            weighted_closeness_centrality)

__all__ = [
    "AnalyticsAnswer", "AnalyticsRequest", "BFSQuery", "ClosenessQuery",
    "ComponentsQuery", "DiameterQuery", "KHopQuery", "QUERY_KINDS",
    "QUERY_TYPES", "RESULT_TYPES", "ReachQuery", "SSSPQuery",
    "WeightedClosenessQuery", "answer_request", "query_kind",
    "result_from_wire", "result_to_wire", "run_query",
]


@dataclass(frozen=True)
class ComponentsQuery:
    """Connected components of the whole graph."""
    batch: int = 64              # BFS lanes seeded per sweep

    kind: ClassVar[str] = "components"


@dataclass(frozen=True)
class ClosenessQuery:
    """Closeness centrality for every vertex.

    ``sources=None`` forces exact, an int samples that many sources,
    ``"auto"`` (default) picks exact for small n, sampled for large n,
    and an explicit id tuple pins the sample (the serving path uses this
    so offline replays reproduce it bit-for-bit).
    """
    sources: int | str | tuple[int, ...] | None = "auto"
    seed: int = 0
    chunk: int = 256             # roots per engine sweep

    kind: ClassVar[str] = "closeness"


@dataclass(frozen=True)
class BFSQuery:
    """Full BFS traversal from each source (one lane each): depth columns
    plus per-source layer/reach counts."""
    sources: tuple[int, ...]

    kind: ClassVar[str] = "bfs"


@dataclass(frozen=True)
class KHopQuery:
    """All vertices within ``k`` hops of each source (one lane each)."""
    sources: tuple[int, ...]
    k: int

    kind: ClassVar[str] = "khop"


@dataclass(frozen=True)
class ReachQuery:
    """Pairwise source->target hop distances (one lane per source);
    ``targets=None`` means all-pairs among the sources."""
    sources: tuple[int, ...]
    targets: tuple[int, ...] | None = None

    kind: ClassVar[str] = "reach"


@dataclass(frozen=True)
class DiameterQuery:
    """Diameter lower/upper bounds by double-sweep lane batches."""
    num_seeds: int = 4
    sweeps: int = 2
    seed: int = 0

    kind: ClassVar[str] = "diameter"


@dataclass(frozen=True)
class SSSPQuery:
    """Shortest-path distances from each source (one tropical lane each,
    delta-stepping sweep). Needs a weighted engine; ``delta=None`` uses
    the ``traversal.sssp.default_delta`` bucket width."""
    sources: tuple[int, ...]
    delta: float | None = None

    kind: ClassVar[str] = "sssp"


@dataclass(frozen=True)
class WeightedClosenessQuery:
    """Weighted closeness centrality for every vertex — ``sources``
    follows the ``ClosenessQuery`` rule (None exact / int sampled /
    "auto" dispatch on n / explicit id tuple). Needs a weighted
    engine."""
    sources: int | str | tuple[int, ...] | None = "auto"
    seed: int = 0
    chunk: int = 64              # dense float lanes per engine sweep
    delta: float | None = None

    kind: ClassVar[str] = "weighted_closeness"


QUERY_TYPES = (ComponentsQuery, ClosenessQuery, BFSQuery, KHopQuery,
               ReachQuery, DiameterQuery, SSSPQuery, WeightedClosenessQuery)

Query = (ComponentsQuery | ClosenessQuery | BFSQuery | KHopQuery
         | ReachQuery | DiameterQuery | SSSPQuery | WeightedClosenessQuery)
Result = (ComponentsResult | ClosenessResult | BFSResult | KHopResult
          | ReachResult | DiameterResult | SSSPDistancesResult)


def query_kind(query_type: type) -> str:
    """The explicit wire tag of a query class. The tag must be declared
    by the class ITSELF (``kind`` ClassVar in its own ``__dict__``) — an
    inherited or missing tag is a wiring bug that would silently break
    envelope serialization, so it raises here instead."""
    k = query_type.__dict__.get("kind")
    if not isinstance(k, str) or not k:
        raise TypeError(
            f"{query_type.__name__} declares no wire tag — every query "
            f"class must define its own `kind: ClassVar[str]`")
    return k


def _build_registry() -> dict[str, type]:
    reg: dict[str, type] = {}
    for t in QUERY_TYPES:
        k = query_kind(t)
        if k in reg:
            raise TypeError(
                f"duplicate query tag {k!r}: {reg[k].__name__} and "
                f"{t.__name__}")
        reg[k] = t
    return reg


# tag -> query class; THE registry every tag consumer derives from
QUERY_KINDS: dict[str, type] = _build_registry()


# ---------------------------------------------------------------------------
# Request/answer envelope.
# ---------------------------------------------------------------------------

_req_ids = itertools.count(1)


@dataclass
class AnalyticsRequest:
    """One serving request: a typed query plus routing/accounting fields.

    ``arrival`` is the layer-clock tick the request becomes visible in a
    replayed trace (0 = immediately); the service stamps real submit
    times itself. ``id`` auto-assigns when left empty."""
    query: Query
    id: str = ""
    tenant: str = "default"
    arrival: int = 0

    def __post_init__(self):
        if type(self.query) not in QUERY_KINDS.values():
            raise TypeError(
                f"unknown analytics query type "
                f"{type(self.query).__name__!r} — expected one of "
                f"{sorted(t.__name__ for t in QUERY_TYPES)}")
        if not self.id:
            self.id = f"q{next(_req_ids)}"

    @property
    def kind(self) -> str:
        return query_kind(type(self.query))

    def to_wire(self) -> dict:
        """JSON-serializable envelope; ``from_wire`` round-trips it."""
        q = {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in asdict(self.query).items()}
        return dict(id=self.id, tenant=self.tenant, arrival=self.arrival,
                    kind=self.kind, query=q)

    @classmethod
    def from_wire(cls, wire: dict) -> "AnalyticsRequest":
        kind = wire.get("kind")
        qtype = QUERY_KINDS.get(kind)
        if qtype is None:       # the ONE unknown-tag error path
            raise ValueError(
                f"unknown query tag {kind!r} — expected one of "
                f"{sorted(QUERY_KINDS)}")
        q = {k: (tuple(v) if isinstance(v, list) else v)
             for k, v in wire.get("query", {}).items()}
        return cls(query=qtype(**q), id=wire.get("id", ""),
                   tenant=wire.get("tenant", "default"),
                   arrival=int(wire.get("arrival", 0)))


# ---------------------------------------------------------------------------
# Result wire codec — full typed results over JSON, bit-identical.
# ---------------------------------------------------------------------------

# result-class-name -> class; the decode allow-list (mirrors QUERY_KINDS
# on the answer side — an unknown result tag is ONE error path here too)
RESULT_TYPES: dict[str, type] = {
    t.__name__: t for t in (BFSResult, ClosenessResult, ComponentsResult,
                            DiameterResult, KHopResult, ReachResult,
                            SSSPDistancesResult)}


def _encode_value(v):
    """JSON-encode one result field. Arrays ship as raw little-endian
    bytes (base64) + dtype/shape, so every dtype — int32 depths, uint32
    lane words, float32 distances, bools — round-trips BIT-identical
    (no float-to-decimal detour). Tuples and QueryMeta are tagged so the
    decode side rebuilds the exact in-process types."""
    if isinstance(v, np.ndarray):
        a = np.ascontiguousarray(v)
        return {"__nd__": [a.dtype.str,  # byte-order-explicit dtype tag
                           list(a.shape),
                           base64.b64encode(a.tobytes()).decode("ascii")]}
    if isinstance(v, np.generic):
        return v.item()              # bare numpy scalar -> python scalar
    if isinstance(v, QueryMeta):
        d = {f.name: _encode_value(getattr(v, f.name))
             for f in fields(QueryMeta)}
        return {"__meta__": d}
    if isinstance(v, tuple):
        return {"__tuple__": [_encode_value(x) for x in v]}
    if isinstance(v, dict):
        return {k: _encode_value(x) for k, x in v.items()}
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    raise TypeError(
        f"result field of type {type(v).__name__!r} has no wire encoding")


def _decode_value(v):
    if isinstance(v, dict):
        if "__nd__" in v:
            dtype, shape, payload = v["__nd__"]
            raw = base64.b64decode(payload.encode("ascii"))
            return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(
                shape).copy()
        if "__meta__" in v:
            kw = {k: _decode_value(x) for k, x in v["__meta__"].items()}
            return QueryMeta(**kw)
        if "__tuple__" in v:
            return tuple(_decode_value(x) for x in v["__tuple__"])
        return {k: _decode_value(x) for k, x in v.items()}
    return v


def result_to_wire(result) -> dict:
    """JSON-serializable envelope of a full typed result;
    ``result_from_wire`` rebuilds an equal value — every array
    bit-identical (pinned in tests)."""
    cls = type(result)
    if cls.__name__ not in RESULT_TYPES:
        raise TypeError(
            f"unknown result type {cls.__name__!r} — expected one of "
            f"{sorted(RESULT_TYPES)}")
    data = {f.name: _encode_value(getattr(result, f.name))
            for f in fields(cls)}
    return {"type": cls.__name__, "fields": data}


def result_from_wire(wire: dict):
    cls = RESULT_TYPES.get(wire.get("type"))
    if cls is None:
        raise ValueError(
            f"unknown result type {wire.get('type')!r} — expected one "
            f"of {sorted(RESULT_TYPES)}")
    kw = {k: _decode_value(v) for k, v in wire.get("fields", {}).items()}
    return cls(**kw)


@dataclass
class AnalyticsAnswer:
    """The answer to one request: the workload's typed result plus the
    uniform ``QueryMeta`` (same object as ``result.meta``)."""
    id: str
    result: Result
    meta: QueryMeta = field(default_factory=QueryMeta)

    def to_wire(self, include_result: bool = False) -> dict:
        """JSON-serializable envelope. The default is the summary form
        (meta only — cheap poll/debug surface); ``include_result=True``
        ships the full typed result through ``result_to_wire``, so the
        HTTP transport's answers decode bit-identical to the in-process
        ones."""
        meta = {k: v for k, v in self.meta.as_dict().items()
                if isinstance(v, (str, int, float, bool, type(None)))}
        wire = dict(id=self.id, kind=self.meta.kind, meta=meta)
        if include_result:
            wire["result"] = result_to_wire(self.result)
        return wire

    @classmethod
    def from_wire(cls, wire: dict) -> "AnalyticsAnswer":
        """Rebuild a full answer from a ``to_wire(include_result=True)``
        envelope (summary-only envelopes have no result to rebuild —
        that raises)."""
        if "result" not in wire:
            raise ValueError(
                "summary envelope has no result payload — produce it "
                "with to_wire(include_result=True)")
        result = result_from_wire(wire["result"])
        return cls(id=wire["id"], result=result, meta=result.meta)


# ---------------------------------------------------------------------------
# Dispatch: ONE handler table keyed on the query class.
# ---------------------------------------------------------------------------

_HANDLERS = {
    ComponentsQuery: lambda eng, q: connected_components(eng, batch=q.batch),
    ClosenessQuery: lambda eng, q: closeness_centrality(
        eng, sources=q.sources, seed=q.seed, chunk=q.chunk),
    BFSQuery: lambda eng, q: bfs_depths(eng, list(q.sources)),
    KHopQuery: lambda eng, q: khop_neighborhood(eng, list(q.sources), q.k),
    ReachQuery: lambda eng, q: reach_hops(
        eng, list(q.sources),
        None if q.targets is None else list(q.targets)),
    DiameterQuery: lambda eng, q: diameter_bounds(
        eng, num_seeds=q.num_seeds, sweeps=q.sweeps, seed=q.seed),
    SSSPQuery: lambda eng, q: sssp_distances(
        eng, list(q.sources), delta=q.delta),
    WeightedClosenessQuery: lambda eng, q: weighted_closeness_centrality(
        eng, sources=q.sources, seed=q.seed, chunk=q.chunk, delta=q.delta),
}


def run_query(g_or_engine, query: Query, **engine_kwargs) -> Result:
    """Dispatch one analytics query. ``g_or_engine`` is a ``CSRGraph``
    (engine built from ``engine_kwargs``: ``lanes=``, ``mode=``, ...) or
    a shared ``LaneEngine``."""
    eng = as_engine(g_or_engine, **engine_kwargs)
    handler = _HANDLERS.get(type(query))
    if handler is None:
        raise TypeError(
            f"unknown analytics query type {type(query).__name__!r} — "
            f"expected one of {[t.__name__ for t in QUERY_TYPES]}")
    return handler(eng, query)


def answer_request(g_or_engine, request: AnalyticsRequest,
                   **engine_kwargs) -> AnalyticsAnswer:
    """Answer one enveloped request offline."""
    result = run_query(g_or_engine, request.query, **engine_kwargs)
    return AnalyticsAnswer(id=request.id, result=result, meta=result.meta)
