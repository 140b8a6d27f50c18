"""Spans and counters inside the port, on the profiler's clock.

``span(name)`` marks a phase of the program. While ``torch.profiler``
records, it opens a profiler range of that name (``_RANGE``), so the phase
lands in the profiler's trace on the clock of the device's events, and
records its host start and end (``time.perf_counter_ns``) and its parent
span into the current sweep's record. ``host_sync(name)`` is the span of a
blocking transfer (a device-to-host read-back, or a pageable upload, which
waits for the queued work) and adds 1 to the sweep's ``host_syncs``
counter; ``count(name, k)`` adds to a counter of the sweep, and
``count_lanes(live)`` adds a step's live lanes and its pool width to
``lanes_live`` and ``lanes_pool``.

``sweep(name)`` opens a sweep record with a fresh id at an analytics entry,
together with a span of that name at the top of it: every span and count of
the thread until it closes belongs to that sweep, and carries its id.
Spans and counts outside any sweep reach the profiler's trace only. The newest
``MAX_SWEEPS`` closed sweeps are kept in a ring; ``recent(k)`` returns the
newest ``k``, oldest first. A sweep keeps its spans as flat columns of
names and integers, which leave no object a span for the garbage collector
to track while the traced work runs; ``Sweep.spans`` builds them into
``Span`` records.

Recording is on exactly while the torch profiler records: every site reads
the profiler's own module flag once, and off it does nothing else (no
profiler range, no clock read, no record), which keeps the cost of a site
to a fraction of a microsecond where an ungated ``record_function`` costs
about ten.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _profiler

__all__ = ["MAX_SWEEPS", "SYNCS", "Span", "Sweep", "count", "count_lanes",
           "host_sync", "recent", "span", "sweep"]

MAX_SWEEPS = 64
SYNCS = "host_syncs"
# a span's profiler range: torch's range of C++ (a host event like
# ``record_function``'s, at about a tenth of its cost, which keeps the
# spans' own time out of the phases they divide), else ``record_function``
_RANGE = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or torch.profiler.record_function)


@dataclass
class Span:
    """One span of a sweep. ``parent`` indexes the enclosing span in the
    sweep's ``spans`` (-1: none); ``sync`` marks a blocking transfer."""
    name: str
    sweep: int
    parent: int
    start_ns: int
    end_ns: int = 0
    sync: bool = False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclass
class Sweep:
    """One sweep's record: its spans in the order they opened (the entry's
    own span first), as columns, and its counters."""
    id: int
    kind: str
    counts: dict = field(default_factory=dict)
    names: list = field(default_factory=list, repr=False)
    parents: list = field(default_factory=list, repr=False)
    starts: list = field(default_factory=list, repr=False)
    ends: list = field(default_factory=list, repr=False)
    syncs: list = field(default_factory=list, repr=False)
    open: list = field(default_factory=list, repr=False)  # open span indices

    @property
    def spans(self) -> list[Span]:
        return [Span(*row) for row in zip(
            self.names, [self.id] * len(self.names), self.parents,
            self.starts, self.ends, self.syncs)]


_RING: deque = deque(maxlen=MAX_SWEEPS)
_IDS = itertools.count(1)
_local = threading.local()


def _current() -> Sweep | None:
    return getattr(_local, "sweep", None)


class _Off:
    """What a site returns while the profiler is off: a context that does
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    """A span while the profiler records."""
    __slots__ = ("name", "sync", "fn", "row", "owner")

    def __init__(self, name: str, sync: bool):
        self.name, self.sync = name, sync

    def __enter__(self):
        self.fn = _RANGE(self.name)
        self.fn.__enter__()
        self.owner = sw = _current()
        if sw is not None:
            self.row = len(sw.names)
            sw.names.append(self.name)
            sw.parents.append(sw.open[-1] if sw.open else -1)
            sw.syncs.append(self.sync)
            sw.ends.append(0)
            sw.open.append(self.row)
            if self.sync:
                sw.counts[SYNCS] = sw.counts.get(SYNCS, 0) + 1
            sw.starts.append(time.perf_counter_ns())
        return self

    def __exit__(self, *exc):
        if self.owner is not None:
            self.owner.ends[self.row] = time.perf_counter_ns()
            self.owner.open.pop()
        self.fn.__exit__(*exc)
        return False


class _SweepOn(_On):
    """A sweep record and its entry span."""
    __slots__ = ()

    def __enter__(self):
        _local.sweep = Sweep(next(_IDS), self.name)
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        _RING.append(self.owner)
        _local.sweep = None
        return False


def span(name: str):
    """A phase of the program, as a context manager."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, False)


def host_sync(name: str):
    """A blocking transfer between the host and the device, as a context
    manager: a span that also adds 1 to ``host_syncs``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, True)


def sweep(name: str):
    """A sweep record with a fresh id, and its entry span ``name``, as a
    context manager."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _SweepOn(name, False)


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to counter ``name`` of the current sweep."""
    if not _profiler._is_profiler_enabled:
        return
    sw = _current()
    if sw is not None:
        sw.counts[name] = sw.counts.get(name, 0) + int(k)


def count_lanes(live) -> None:
    """Add a step's live lanes (a host bool array over its lane pool) to
    ``lanes_live``, and the pool's width to ``lanes_pool``."""
    if not _profiler._is_profiler_enabled:
        return
    count("lanes_live", int(live.sum()))
    count("lanes_pool", live.shape[0])


def recent(k: int = MAX_SWEEPS) -> list[Sweep]:
    """The newest ``k`` closed sweeps, oldest first."""
    if k <= 0:
        return []
    return list(_RING)[-k:]
