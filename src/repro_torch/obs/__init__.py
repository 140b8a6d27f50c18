"""repro_torch.obs — unified telemetry: metrics, sweep flight recorder,
traces (port of ``repro.obs``).

The paper's argument is made of per-layer counters (frontier density,
TD/BU phase, edges inspected, exchange volume); this package is where
they all land, for every engine and for the serving front door:

* :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry with
  Prometheus text exposition (``metrics_text``).
* :mod:`repro_torch.obs.sweeplog` — the canonical per-layer ``LayerRecord``
  schema + ``SweepRecorder`` hook every engine driver emits through
  (``recorder=`` kwarg; off by default, zero-cost when disabled).
* :mod:`repro_torch.obs.traceviz` — Chrome trace-event JSON export (Perfetto-
  loadable) of sweeps and service request lifecycles, + JSONL sink.
* :mod:`repro_torch.obs.spans` — spans and counters inside the engines'
  hot path (the analytics entry, each engine step and its phases, the
  parent derivation, every blocking host sync), recorded only while the
  torch profiler records.

``Telemetry`` is the bundle the stack threads through — pass one to
``LaneEngine(telemetry=...)`` / ``ServiceConfig(telemetry=...)`` and it
collects the sweeps, feeds the registry, and optionally streams a JSONL
flight log::

    tel = Telemetry()
    eng = LaneEngine(g, telemetry=tel)
    eng.sweep(roots)
    print(tel.metrics_text())
    write_chrome_trace("sweep.json", sweep_trace_events(tel.last_sweep()))

The hot path's own spans need no bundle: run ``torch.profiler.profile``
around the work. The spans land in the profiler's trace beside the
device's kernels, on the same clock (``prof.export_chrome_trace(path)``
writes it for Perfetto), and each ``LaneEngine.sweep`` or ``.sssp_sweep``
under the profiler leaves a record of its spans and counters (host syncs,
live and pooled lanes), which ``spans.recent(k)`` returns::

    with torch.profiler.profile() as prof:
        eng.sweep(roots)
    prof.export_chrome_trace("sweep_spans.json")
    rec = spans.recent(1)[0]
    print(rec.counts["host_syncs"], [(s.name, s.ns) for s in rec.spans])
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.obs.doctor import (DoctorReport, Finding, diagnose, diagnose_log,
                              records_from_jsonl, replay_switch,
                              split_sweeps)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge, Histogram,
                               MetricsRegistry, default_registry,
                               metrics_text)
# re-exported, outside ``__all__``, which lists the reference's names
from repro_torch.obs import spans as spans
from repro_torch.obs.server import ObservabilityServer
from repro_torch.obs.slo import SLOConfig, SLOMonitor
from repro_torch.obs.sweeplog import (LayerRecord, SweepRecorder, drive_recorded,
                                record_step, snapshot_state)
from repro_torch.obs.traceviz import (FlightSink, service_trace_events,
                                sweep_trace_events, validate_trace_events,
                                write_chrome_trace)

__all__ = [
    "Counter", "DEFAULT_BUCKETS", "DoctorReport", "Finding", "FlightSink",
    "Gauge", "Histogram", "LayerRecord", "MetricsRegistry",
    "ObservabilityServer", "SLOConfig", "SLOMonitor", "SweepRecorder",
    "Telemetry", "default_registry", "diagnose", "diagnose_log",
    "drive_recorded", "metrics_text", "record_step",
    "records_from_jsonl", "replay_switch", "service_trace_events",
    "snapshot_state", "split_sweeps", "sweep_trace_events",
    "validate_trace_events", "write_chrome_trace",
]


@dataclass
class Telemetry:
    """One telemetry bundle for a stack of components.

    ``record_sweeps=False`` keeps the registry live but makes
    ``recorder()`` return None — components then take their recorder-off
    fast path (the engines' drains) untouched. ``flight_path``
    streams every ``LayerRecord`` to a JSONL flight log as it is
    recorded. Completed/ongoing recorders are kept in ``sweeps``
    (bounded by ``max_sweeps``, oldest dropped)."""
    record_sweeps: bool = True
    registry: MetricsRegistry = field(default_factory=MetricsRegistry)
    flight_path: str | None = None
    max_sweeps: int = 64
    sweeps: list = field(default_factory=list)
    _sink: FlightSink | None = field(default=None, repr=False)

    def recorder(self, engine: str, **meta) -> SweepRecorder | None:
        """A fresh per-sweep recorder (None when sweep recording is off
        — callers pass it straight through as the ``recorder=`` kwarg)."""
        if not self.record_sweeps:
            return None
        if self.flight_path and self._sink is None:
            self._sink = FlightSink(self.flight_path)
        rec = SweepRecorder(engine=engine, meta=meta,
                            registry=self.registry, sink=self._sink)
        self.sweeps.append(rec)
        dropped = len(self.sweeps) - self.max_sweeps
        if dropped > 0:
            # no silent caps: eviction from the bounded sweep list is
            # visible on the scrape surface
            self.registry.counter(
                "obs_sweeps_dropped_total",
                "recorded sweeps evicted by the max_sweeps bound").inc(
                    dropped)
            del self.sweeps[:-self.max_sweeps]
        return rec

    def last_sweep(self) -> SweepRecorder | None:
        return self.sweeps[-1] if self.sweeps else None

    def metrics_text(self) -> str:
        return metrics_text(self.registry)

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None
