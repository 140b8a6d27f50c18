"""Online serving of analytics queries — the production front door (port
of ``repro.serving``).

``AnalyticsService`` wraps the lane engines behind an admission-
controlled, optionally threaded submit/poll/result API over the unified
``AnalyticsRequest``/``AnalyticsAnswer`` envelope of
``repro_torch.analytics.api``:

* ``service`` — the service itself: per-engine FIFO dispatch into the
  packed MS-BFS and delta-stepping tropical lane pools, mid-sweep
  streaming read-outs (depth-k khop / reach answers BEFORE lane flush,
  bit-identical to offline ``run_query`` by construction), epoch slot
  recycling, and a worker thread for async use;
* ``admission`` — the REJECTED/QUEUED/RUNNING/DONE lifecycle plus the
  bounded-queue and per-tenant-quota front door;
* ``trace`` — workload-mix parsing (validated against the ONE tag
  registry ``QUERY_KINDS``) and deterministic synthetic traces;
* ``stats`` — layer-clock sojourn percentiles (p50/p99), answered-early
  fraction, TEPS.

Quick start::

    from repro_torch.analytics import KHopQuery
    from repro_torch.serving import AnalyticsService

    with AnalyticsService(g, slots=64, tenant_quota=8) as svc:
        rec = svc.submit(KHopQuery(sources=(3,), k=2))
        print(svc.result(rec.request.id).result.counts)
"""
from repro_torch.serving.admission import (AdmissionController, DONE,
                                           LIFECYCLE, QUEUED, REJECTED,
                                           RUNNING)
from repro_torch.serving.service import (AnalyticsService, RequestRecord,
                                         ServiceConfig)
from repro_torch.serving.stats import sojourn_summary, summarize
from repro_torch.serving.trace import parse_mix, synthetic_trace

__all__ = [
    "AdmissionController", "AnalyticsService", "DONE", "LIFECYCLE",
    "QUEUED", "REJECTED", "RequestRecord", "RUNNING", "ServiceConfig",
    "parse_mix", "sojourn_summary", "summarize", "synthetic_trace",
]
