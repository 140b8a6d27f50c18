"""What a driver's loop yields, and the loops that drivers share.

A driver's loop submits requests to the system under test, in its own
pattern of arrivals, and yields one ``Record`` as each request finishes;
the harness keeps the window, takes the records until the window's time is
up, and sums them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch


@dataclass
class Record:
    """One finished request: its latency in seconds (from its arrival to
    its answer on the device, synchronised), the work it did in the
    benchmark's own units (``{"edges": ...}``), its input, and its answer
    (``{name: tensor}``, what the check compares)."""
    latency_s: float
    work: dict
    request: object
    answer: dict | None


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(serve, requests, device, work, answer):
    """One client: each request is submitted when the last has finished.
    ``serve(request)`` is the timed call; ``work(request)`` and
    ``answer(result)`` make the record after its time is read."""
    for req in requests:
        t0 = time.perf_counter()
        out = serve(req)
        sync(device)
        dt = time.perf_counter() - t0
        rec = Record(dt, work(req), req, answer(out))
        # the record holds what the check needs; the rest of the result
        # goes now, not during the next request
        del out
        yield rec
