"""Readers of the program's own spans and counters in the traced window.

The program records them itself (``repro_torch.obs.spans``) while the
profiler records: each request's ``LaneEngine.sweep`` or ``.sssp_sweep``
leaves one sweep record, whose spans nest by parent and whose sync spans
(``sync``) are its blocking transfers between the host and the device. The
traced window runs exactly ``trace.requests`` requests under the profiler,
and nothing else records, so the newest that many records are the window's.
A program that keeps no such records, or fewer, reads None, and the metric
is left out of the line.
"""
from __future__ import annotations

# the analytics entry's own phases: the engine's set-up, SSSP's bucket width
# and the result's assembly (the drain and the parents are spans of their own)
ENTRY = ("msbfs.init", "msbfs.result", "sssp.delta", "sssp.init",
         "sssp.result")


def sweeps(t):
    """The sweep records of the traced window's requests, or None."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    got = spans.recent(t.requests) if t.requests > 0 else []
    return got if got and len(got) == t.requests else None


def _inside(sweep, span, test) -> bool:
    """Whether an enclosing span of ``span`` passes ``test``."""
    j = span.parent
    while j >= 0:
        if test(sweep.spans[j]):
            return True
        j = sweep.spans[j].parent
    return False


def _host_ms(t, test):
    """Milliseconds a request spends in the spans that pass ``test``, less
    the sync spans inside them."""
    recs = sweeps(t)
    if recs is None:
        return None
    ns = 0
    for sw in recs:
        for s in sw.spans:
            if test(s):
                ns += s.ns
            elif s.sync and _inside(sw, s, test):
                ns -= s.ns
    return ns * 1e-6 / len(recs)


def engine_host_ms(t):
    """The host's own work in the lane engine, in ms a request: its steps'
    spans (``*.step``) less the syncs inside them."""
    return _host_ms(t, lambda s: s.name.endswith(".step"))


def entry_host_ms(t):
    """The host's own work in the analytics entry outside the drain and the
    parents, in ms a request: the entry's phases (``ENTRY``) less their
    syncs."""
    return _host_ms(t, lambda s: s.name in ENTRY)


def host_wait_ms(t):
    """Milliseconds a request's host spends blocked in sync spans, anywhere
    in the sweep."""
    recs = sweeps(t)
    if recs is None:
        return None
    return sum(s.ns for sw in recs for s in sw.spans
               if s.sync) * 1e-6 / len(recs)


def host_syncs(t):
    """Blocking transfers a request (the ``host_syncs`` counter)."""
    recs = sweeps(t)
    if recs is None:
        return None
    return sum(sw.counts.get("host_syncs", 0) for sw in recs) / len(recs)


def lane_occupancy(t):
    """The engine steps' live lanes as a share of their pool's lanes, in %,
    over the window's steps (the ``lanes_live`` and ``lanes_pool``
    counters)."""
    recs = sweeps(t)
    if recs is None:
        return None
    pool = sum(sw.counts.get("lanes_pool", 0) for sw in recs)
    live = sum(sw.counts.get("lanes_live", 0) for sw in recs)
    return 100.0 * live / pool if pool else None
