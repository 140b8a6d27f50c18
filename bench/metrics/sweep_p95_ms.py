"""sweep_p95_ms: the 95th percentile of the latencies of all the window's
requests (a request: a batch of roots submitted together, until its
results are on the device and synchronised), in milliseconds, by linear
interpolation (numpy's default)."""
import numpy as np


def read(w):
    return float(np.percentile([r.latency_s for r in w.records], 95)) * 1e3
