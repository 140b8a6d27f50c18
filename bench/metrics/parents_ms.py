"""parents_ms: milliseconds a request spends in deriving the Graph500
parent trees from the depths (reached through
``msbfs_engine_result(derive_parents=True)``), the device synchronised
at both ends, summed over the traced window's requests and divided by
their number. A span of the benchmark's own around
``repro_torch.core.msbfs:_derive_parents``."""
import profiling

SPANS = {"parents_ms": "repro_torch.core.msbfs:_derive_parents"}


def read(t):
    return profiling.span_ms(t, "parents_ms")
