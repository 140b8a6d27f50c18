"""Chrome trace-event export + JSONL flight-recorder sink (port of
``repro.obs.traceviz``, copied).

Two recorded timelines become Perfetto-loadable JSON
(https://ui.perfetto.dev → "Open trace file", or chrome://tracing):

* ``sweep_trace_events`` — a ``SweepRecorder``'s layer stream as one
  "X" (complete) span per engine step, positioned by cumulative recorded
  wall time, with "C" counter tracks for frontier density, edges
  relaxed, and exchange bytes riding underneath. Span args carry the
  full ``LayerRecord`` aggregates, so clicking a layer in Perfetto shows
  mode / active lanes / words / bytes.
* ``service_trace_events`` — ``AnalyticsService`` request lifecycles on
  the service's layer clock (1 layer = ``layer_us`` µs): a QUEUED span
  from submission to dispatch, a RUNNING span from dispatch to answer,
  and an "i" instant marker on answers streamed mid-sweep before lane
  flush (the early read-outs). One Perfetto track ("thread") per
  request, grouped under a service process.

Everything is the plain trace-event JSON array format wrapped as
``{"traceEvents": [...]}``; ``validate_trace_events`` is the schema
check the tests pin (and a cheap guard before handing a file to a UI).
``FlightSink`` is the append-only JSONL sink a ``SweepRecorder`` can
stream records into as they happen — the post-mortem flight recorder
for sweeps that never finish.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

__all__ = [
    "FlightSink", "service_trace_events", "sweep_trace_events",
    "validate_trace_events", "write_chrome_trace",
]

_PHASES = {"X", "B", "E", "i", "M", "C"}
# per-phase required keys on top of the common name/ph/pid/tid
_REQUIRED = {"X": ("ts", "dur"), "B": ("ts",), "E": ("ts",),
             "i": ("ts",), "C": ("ts", "args"), "M": ("args",)}


def _meta(pid: int, tid: int | None, key: str, value: str) -> dict:
    ev = dict(name=key, ph="M", pid=pid, tid=0 if tid is None else tid,
              args={"name": value})
    return ev


def sweep_trace_events(recorder, *, pid: int = 1) -> list[dict]:
    """One "X" span per recorded engine step + counter tracks, on the
    recorder's own wall-clock (µs since sweep start)."""
    name = f"sweep:{recorder.engine or 'engine'}"
    events = [_meta(pid, None, "process_name", name),
              _meta(pid, 1, "thread_name", "layers")]
    ts = 0.0
    for r in recorder.records:
        dur = max(r.wall_ms * 1e3, 1.0)
        events.append(dict(
            name=f"L{r.layer} {r.mode}", ph="X", pid=pid, tid=1,
            ts=round(ts, 3), dur=round(dur, 3), cat=r.kind,
            args=dict(layer=r.layer, mode=r.mode,
                      active_lanes=r.active_lanes,
                      frontier_words=r.frontier_words,
                      frontier_density=round(r.frontier_density, 6),
                      edges_relaxed=r.edges_relaxed,
                      words_touched=r.words_touched,
                      exch_bytes=r.exch_bytes,
                      exch_format=r.exch_format)))
        events.append(dict(name="frontier_density", ph="C", pid=pid,
                           tid=1, ts=round(ts, 3),
                           args={"density":
                                 round(r.frontier_density, 6)}))
        events.append(dict(name="edges_relaxed", ph="C", pid=pid, tid=1,
                           ts=round(ts, 3),
                           args={"edges": r.edges_relaxed}))
        if r.exch_bytes:
            events.append(dict(name="exch_bytes", ph="C", pid=pid,
                               tid=1, ts=round(ts, 3),
                               args={"bytes": r.exch_bytes}))
        ts += dur
    return events


def service_trace_events(records, *, pid: int = 2,
                         layer_us: float = 1000.0) -> list[dict]:
    """Request lifecycles (iterable of ``RequestRecord``) as spans on the
    service layer clock — QUEUED wait, RUNNING sweep residency, and an
    instant marker where the answer streamed out before lane flush."""
    events = [_meta(pid, None, "process_name", "analytics-service")]
    recs = sorted(records, key=lambda r: (r.submit_layer, r.request.id))
    for tid, rec in enumerate(recs, start=1):
        rid = rec.request.id
        events.append(_meta(pid, tid, "thread_name",
                            f"{rec.kind}:{rid}"))
        args = dict(id=rid, kind=rec.kind, tenant=rec.request.tenant,
                    status=rec.status)
        if rec.status == "REJECTED":
            events.append(dict(name=f"REJECTED {rid}", ph="i", pid=pid,
                               tid=tid, ts=rec.submit_layer * layer_us,
                               s="t",
                               args=dict(**args, reason=rec.reason)))
            continue
        dispatch = (rec.dispatch_layer if rec.dispatch_layer >= 0
                    else rec.submit_layer)
        queued = max(dispatch - rec.submit_layer, 0) * layer_us
        events.append(dict(name=f"QUEUED {rid}", ph="X", pid=pid,
                           tid=tid, ts=rec.submit_layer * layer_us,
                           dur=max(queued, 1.0), cat="lifecycle",
                           args=args))
        if rec.dispatch_layer < 0:
            continue
        end = rec.answer_layer if rec.answer_layer >= 0 else dispatch
        running = max(end - dispatch, 0) * layer_us
        events.append(dict(
            name=f"RUNNING {rid}", ph="X", pid=pid, tid=tid,
            ts=dispatch * layer_us, dur=max(running, 1.0),
            cat="lifecycle",
            args=dict(**args, engine=rec.engine,
                      lanes=rec.lanes_used, sojourn=rec.sojourn)))
        if rec.answer_layer >= 0 and rec.answered_early:
            events.append(dict(name=f"early-readout {rid}", ph="i",
                               pid=pid, tid=tid,
                               ts=rec.answer_layer * layer_us, s="t",
                               args=args))
    return events


def validate_trace_events(events) -> list[dict]:
    """Schema-check a trace-event list; returns it (for chaining) or
    raises ``ValueError`` naming the first offending event."""
    if not isinstance(events, list):
        raise ValueError(f"trace events must be a list, got "
                         f"{type(events).__name__}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object: {ev!r}")
        ph = ev.get("ph")
        if ph not in _PHASES:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        for k in ("name", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"event {i} ({ph}) missing {k!r}")
        if not isinstance(ev["pid"], int) or not isinstance(
                ev["tid"], int):
            raise ValueError(f"event {i}: pid/tid must be integers")
        for k in _REQUIRED[ph]:
            if k not in ev:
                raise ValueError(f"event {i} ({ph}) missing {k!r}")
        if "ts" in ev and not isinstance(ev["ts"], (int, float)):
            raise ValueError(f"event {i}: ts must be a number")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i}: args must be an object")
        if ph == "M" and "name" not in ev.get("args", {}):
            raise ValueError(f"event {i}: metadata needs args.name")
    return events


def write_chrome_trace(path: str, events: list[dict]) -> str:
    """Validate + write ``{"traceEvents": [...]}`` JSON to ``path``."""
    validate_trace_events(events)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        f.write("\n")
    return path


@dataclass
class FlightSink:
    """Append-only JSONL sink — one line per ``LayerRecord`` dict, flushed
    per write so a crashed sweep still leaves its flight log behind.
    Usable directly as ``SweepRecorder(sink=FlightSink(path))`` and as a
    context manager."""
    path: str
    _fh: object = field(default=None, repr=False)

    def write(self, record: dict) -> None:
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
