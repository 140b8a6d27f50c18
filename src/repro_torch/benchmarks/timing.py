"""Wall-clock timing shared by the benchmark scripts."""
from __future__ import annotations

import time

import torch


def timed(fn, device):
    """(wall seconds, result) of ``fn`` after one warm-up call; the time
    ends with a device sync."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out
