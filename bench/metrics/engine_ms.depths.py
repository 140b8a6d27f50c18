"""engine_ms.depths: milliseconds a request spends in the MS-BFS lane
engine's drain (every step of the sweep) in the depths cell, the device
synchronised at both ends, summed over the traced window's requests and
divided by their number. A span of the benchmark's own around
``repro_torch.core.msbfs:msbfs_engine_drain``."""
import profiling

SPANS = {"engine_ms.depths": "repro_torch.core.msbfs:msbfs_engine_drain"}


def read(t):
    return profiling.span_ms(t, "engine_ms.depths")
