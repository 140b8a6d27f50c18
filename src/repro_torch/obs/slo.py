"""SLO monitor for the serving stack — breach accounting behind /readyz
(port of ``repro.obs.slo``, copied).

The service already *measures* everything an operator would alert on
(sojourn layers, queue depth, admission outcomes); this module holds the
*targets* and the rolling evaluation:

* ``SLOConfig`` — the declared objectives: p99 submit-to-answer sojourn
  in layers, maximum pending-queue depth, maximum reject rate over the
  rolling request window. Any target left ``None`` is simply not
  evaluated (a service with no SLO config at all skips this module
  entirely — ``ServiceConfig(slo=None)`` is the default).
* ``SLOMonitor`` — fed by the service per event (admission outcome,
  answer sojourn) and per scheduler tick (queue depth); ``evaluate()``
  recomputes each objective over the window and maintains the registry
  surface: one ``slo_healthy`` gauge (1/0 — the /readyz bit), per-target
  ``slo_target_healthy{slo=...}`` gauges, observed-value gauges, and a
  monotone ``slo_breaches_total{slo=...}`` counter bumped on each
  healthy→breached TRANSITION (not per tick, so a sustained breach is
  one incident, not a rate).

Percentiles use the serving stack's nearest-rank ``percentile`` — the
same arithmetic as the service's sojourn summary, so an SLO breach and a
served run's p99 are the same number.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

__all__ = ["SLOConfig", "SLOMonitor"]

# target keys, wire-stable (metric label values + health JSON keys)
P99_SOJOURN = "p99_sojourn_layers"
QUEUE_DEPTH = "queue_depth"
REJECT_RATE = "reject_rate"


@dataclass(frozen=True)
class SLOConfig:
    """Declared service-level objectives (None = not evaluated).

    ``window`` bounds the rolling sample the rate/percentile targets are
    computed over — sojourns and admission outcomes beyond it age out,
    so a long-past incident cannot pin /readyz unhealthy forever."""
    p99_sojourn_layers: float | None = None
    max_queue_depth: int | None = None
    max_reject_rate: float | None = None
    window: int = 256

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if (self.max_reject_rate is not None
                and not 0.0 <= self.max_reject_rate <= 1.0):
            raise ValueError(
                f"max_reject_rate must be in [0, 1], got "
                f"{self.max_reject_rate}")

    def targets(self) -> dict[str, float]:
        """The configured objectives by wire key."""
        out = {}
        if self.p99_sojourn_layers is not None:
            out[P99_SOJOURN] = float(self.p99_sojourn_layers)
        if self.max_queue_depth is not None:
            out[QUEUE_DEPTH] = float(self.max_queue_depth)
        if self.max_reject_rate is not None:
            out[REJECT_RATE] = float(self.max_reject_rate)
        return out


class SLOMonitor:
    """Rolling SLO evaluation over one service's event stream.

    Not thread-safe on its own — the service calls it under its lock,
    exactly like the admission controller."""

    def __init__(self, config: SLOConfig, registry=None):
        self.config = config
        self.registry = registry
        self._sojourns: deque = deque(maxlen=config.window)
        self._admissions: deque = deque(maxlen=config.window)
        self._queue_depth = 0
        # target key -> currently breached? (drives transition counting)
        self._breached: dict[str, bool] = {
            k: False for k in config.targets()}
        self.breaches = 0            # total healthy->breached transitions

    # -- event feed (called by the service) -------------------------------

    def observe_admission(self, admitted: bool) -> None:
        self._admissions.append(bool(admitted))

    def observe_sojourn(self, layers: float) -> None:
        self._sojourns.append(float(layers))

    def observe_queue_depth(self, depth: int) -> None:
        self._queue_depth = int(depth)

    # -- evaluation -------------------------------------------------------

    def observed(self) -> dict[str, float]:
        """Current observed value per configured target key."""
        # imported here: the serving package imports the engines, whose
        # spans import this package
        from repro_torch.serving.stats import percentile
        out = {}
        for key in self.config.targets():
            if key == P99_SOJOURN:
                out[key] = percentile(list(self._sojourns), 99)
            elif key == QUEUE_DEPTH:
                out[key] = float(self._queue_depth)
            else:
                n = len(self._admissions)
                rej = sum(1 for a in self._admissions if not a)
                out[key] = rej / n if n else 0.0
        return out

    def evaluate(self) -> dict[str, bool]:
        """Re-evaluate every configured objective; returns per-target
        health, updates the registry gauges/counters, and records breach
        transitions."""
        targets = self.config.targets()
        observed = self.observed()
        ok: dict[str, bool] = {}
        for key, target in targets.items():
            ok[key] = observed[key] <= target
            if not ok[key] and not self._breached[key]:
                self.breaches += 1
                if self.registry is not None:
                    self.registry.counter(
                        "slo_breaches_total",
                        "healthy-to-breached SLO transitions",
                        ("slo",)).labels(slo=key).inc()
            self._breached[key] = not ok[key]
        if self.registry is not None:
            for key in targets:
                self.registry.gauge(
                    "slo_observed", "current observed value per SLO",
                    ("slo",)).labels(slo=key).set(observed[key])
                self.registry.gauge(
                    "slo_target", "configured target per SLO",
                    ("slo",)).labels(slo=key).set(targets[key])
                self.registry.gauge(
                    "slo_target_healthy", "1 while the SLO holds",
                    ("slo",)).labels(slo=key).set(float(ok[key]))
            self.registry.gauge(
                "slo_healthy",
                "1 while every configured SLO holds (the /readyz bit)",
            ).set(float(all(ok.values())) if ok else 1.0)
        return ok

    def healthy(self) -> bool:
        """True while every configured objective holds (vacuously true
        with no targets). Evaluates fresh — the /readyz read path."""
        return all(self.evaluate().values())

    def peek(self) -> dict:
        """JSON-ready view for /readyz: targets, observed values,
        per-target health, breach transitions so far. NON-mutating —
        no registry writes, no breach-transition accounting — so the
        lock-free health probe can call it concurrently with the
        service's own per-tick ``evaluate()``."""
        targets = self.config.targets()
        observed = self.observed()
        ok = {k: observed[k] <= t for k, t in targets.items()}
        return dict(targets=targets, observed=observed,
                    healthy_per_target=ok,
                    healthy=all(ok.values()),
                    breaches=self.breaches,
                    window=self.config.window)

    def snapshot(self) -> dict:
        """``peek()`` after a full ``evaluate()`` (registry + breach
        accounting refreshed)."""
        self.evaluate()
        return self.peek()
