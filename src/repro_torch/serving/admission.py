"""Admission control for the analytics service (port of
``repro.serving.admission``, copied).

Every request moves through ONE explicit lifecycle::

    submit -> REJECTED                  (front door said no — final)
           -> QUEUED -> RUNNING -> DONE (admitted, dispatched, answered)

``AdmissionController`` owns the two front-door bounds:

* ``max_pending`` — total requests sitting in the service's pending
  queue (QUEUED). When the queue is full, new submissions are REJECTED
  immediately instead of growing an unbounded backlog — backpressure is
  explicit and observable, never an OOM.
* ``tenant_quota`` — per-tenant cap on in-flight requests
  (QUEUED + RUNNING). One chatty tenant saturating the lane pool cannot
  starve the others: its submissions bounce with a quota reason while
  other tenants keep admitting.

The controller is pure bookkeeping (no locks — the service serializes
calls under its own lock) and deterministic, so admission decisions in a
replayed trace reproduce exactly.
"""
from __future__ import annotations

from collections import Counter

__all__ = ["AdmissionController", "DONE", "LIFECYCLE", "QUEUED",
           "REJECTED", "RUNNING"]

# request lifecycle states (wire-stable strings)
REJECTED = "REJECTED"
QUEUED = "QUEUED"
RUNNING = "RUNNING"
DONE = "DONE"
LIFECYCLE = (REJECTED, QUEUED, RUNNING, DONE)


class AdmissionController:
    """Bounded-queue + per-tenant-quota admission decisions."""

    def __init__(self, max_pending: int = 1024,
                 tenant_quota: int | None = None):
        if max_pending < 1:
            raise ValueError(
                f"max_pending must be >= 1, got {max_pending}")
        if tenant_quota is not None and tenant_quota < 1:
            raise ValueError(
                f"tenant_quota must be >= 1 (or None), got {tenant_quota}")
        self.max_pending = int(max_pending)
        self.tenant_quota = None if tenant_quota is None else int(
            tenant_quota)
        self._pending = 0            # QUEUED
        self._inflight = Counter()   # per-tenant QUEUED + RUNNING
        self.rejected = 0

    def admit(self, tenant: str) -> tuple[bool, str | None]:
        """Decide one submission. Returns ``(True, None)`` and takes the
        QUEUED + in-flight slots, or ``(False, reason)``."""
        if self._pending >= self.max_pending:
            self.rejected += 1
            return False, (f"queue full: {self._pending} pending >= "
                           f"max_pending={self.max_pending}")
        if (self.tenant_quota is not None
                and self._inflight[tenant] >= self.tenant_quota):
            self.rejected += 1
            return False, (f"tenant {tenant!r} quota: "
                           f"{self._inflight[tenant]} in flight >= "
                           f"tenant_quota={self.tenant_quota}")
        self._pending += 1
        self._inflight[tenant] += 1
        return True, None

    def on_dispatch(self, tenant: str) -> None:
        """QUEUED -> RUNNING: frees a pending-queue slot (the tenant's
        in-flight slot stays held until the answer lands)."""
        self._pending -= 1

    def on_done(self, tenant: str) -> None:
        """RUNNING (or batch-inline) -> DONE: frees the tenant slot."""
        self._inflight[tenant] -= 1
        if self._inflight[tenant] <= 0:
            del self._inflight[tenant]

    @property
    def pending(self) -> int:
        return self._pending

    def inflight(self, tenant: str) -> int:
        return self._inflight[tenant]
