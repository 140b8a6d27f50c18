"""Lightweight metrics registry with Prometheus-style text exposition (port
of ``repro.obs.metrics``, copied: the port imports nothing of ``repro``).

The serving stack needs scrape-able operational counters (requests by
kind and status, sojourn histograms, engine layers, exchange bytes)
without pulling a client library into the container. This module is the
minimal registry that covers the repo's needs:

* three instrument kinds — ``Counter`` (monotone ``inc``), ``Gauge``
  (``set``/``inc``/``dec``), ``Histogram`` (``observe`` into cumulative
  buckets + sum/count) — each optionally labelled;
* one ``MetricsRegistry`` holding them, thread-safe (the service worker
  thread and the submitting threads touch the same series);
* ``metrics_text()`` — the Prometheus text exposition format
  (``# HELP`` / ``# TYPE`` / one line per series), so the output pastes
  straight into a Prometheus scrape or ``promtool check metrics``.

Registration is idempotent: asking for an existing name with the same
kind and label names returns the existing instrument; a mismatched
re-registration raises (two subsystems silently sharing one name with
different schemas is the bug this catches). Per-instrument label
cardinality is bounded (``max_series``) so a label value leaking request
ids cannot grow memory without bound — crossing the bound raises.
"""
from __future__ import annotations

import threading

__all__ = [
    "Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "metrics_text",
]

# layer-clock sojourns and per-layer wall-ms both land comfortably here
DEFAULT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                   1000.0)

_MAX_SERIES_DEFAULT = 1000


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _format_value(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _series_key(labelnames, labelvalues) -> tuple:
    return tuple(str(labelvalues[k]) for k in labelnames)


def _labels_text(labelnames, key: tuple, extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(v)}"' for k, v in zip(labelnames, key)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Instrument:
    """Shared plumbing: label validation, bounded series map, locking."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames=(),
                 max_series: int = _MAX_SERIES_DEFAULT):
        if not name or not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_series = max_series
        self._series: dict[tuple, object] = {}
        self._lock = threading.Lock()

    def _child(self):
        raise NotImplementedError

    def labels(self, **labelvalues):
        """The series for one label-value combination (created on first
        use; raises past ``max_series`` distinct combinations)."""
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {sorted(self.labelnames)}, "
                f"got {sorted(labelvalues)}")
        key = _series_key(self.labelnames, labelvalues)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                if len(self._series) >= self.max_series:
                    raise ValueError(
                        f"{self.name}: label cardinality bound "
                        f"{self.max_series} exceeded — a label value is "
                        f"probably carrying an unbounded id")
                s = self._series[key] = self._child()
            return s

    def _default(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} is labelled {self.labelnames} — call "
                f".labels(...) first")
        return self.labels()

    def _sorted_series(self):
        with self._lock:
            return sorted(self._series.items())


class _CounterSeries:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        self.value += amount


class Counter(_Instrument):
    kind = "counter"

    def _child(self):
        return _CounterSeries()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def expose(self) -> list[str]:
        return [f"{self.name}{_labels_text(self.labelnames, key)} "
                f"{_format_value(s.value)}"
                for key, s in self._sorted_series()]


class _GaugeSeries:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class Gauge(_Instrument):
    kind = "gauge"

    def _child(self):
        return _GaugeSeries()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def expose(self) -> list[str]:
        return [f"{self.name}{_labels_text(self.labelnames, key)} "
                f"{_format_value(s.value)}"
                for key, s in self._sorted_series()]


class _HistogramSeries:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                break


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name: str, help: str = "", labelnames=(),
                 buckets=DEFAULT_BUCKETS,
                 max_series: int = _MAX_SERIES_DEFAULT):
        super().__init__(name, help, labelnames, max_series)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = b

    def _child(self):
        return _HistogramSeries(self.buckets)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def expose(self) -> list[str]:
        lines = []
        for key, s in self._sorted_series():
            cum = 0
            for bound, c in zip(s.buckets, s.counts):
                cum += c
                le = _labels_text(self.labelnames, key,
                                  f'le="{_format_value(bound)}"')
                lines.append(f"{self.name}_bucket{le} {cum}")
            inf = _labels_text(self.labelnames, key, 'le="+Inf"')
            lines.append(f"{self.name}_bucket{inf} {s.count}")
            lt = _labels_text(self.labelnames, key)
            lines.append(f"{self.name}_sum{lt} {_format_value(s.sum)}")
            lines.append(f"{self.name}_count{lt} {s.count}")
        return lines


class MetricsRegistry:
    """Named instruments + the text exposition over all of them."""

    def __init__(self):
        self._metrics: dict[str, _Instrument] = {}
        self._lock = threading.Lock()

    def _register(self, cls, name: str, help: str, labelnames, **kw):
        labelnames = tuple(labelnames)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}")
                return m
            m = self._metrics[name] = cls(name, help, labelnames, **kw)
            return m

    def counter(self, name: str, help: str = "", labelnames=()) -> Counter:
        return self._register(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "", labelnames=()) -> Gauge:
        return self._register(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labelnames,
                              buckets=buckets)

    def expose(self) -> str:
        """Prometheus text exposition over every registered instrument."""
        out = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                out.append(f"# HELP {name} {m.help}")
            out.append(f"# TYPE {name} {m.kind}")
            out.extend(m.expose())
        return "\n".join(out) + ("\n" if out else "")


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (for callers that don't thread their own
    ``Telemetry`` bundle through)."""
    return _DEFAULT


def metrics_text(registry: MetricsRegistry | None = None) -> str:
    """Text exposition of ``registry`` (the process default when None)."""
    return (registry or _DEFAULT).expose()
