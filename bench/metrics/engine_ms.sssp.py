"""engine_ms.sssp: milliseconds a request spends in the delta-stepping lane
engine's drain (every step of the sweep), the device synchronised at
both ends, summed over the traced window's requests and divided by their
number. A span of the benchmark's own around
``repro_torch.traversal.sssp:sssp_engine_drain``."""
import profiling

SPANS = {"engine_ms.sssp": "repro_torch.traversal.sssp:sssp_engine_drain"}


def read(t):
    return profiling.span_ms(t, "engine_ms.sssp")
