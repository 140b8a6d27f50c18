"""Weighted semiring traversal: SSSP lanes on the packed-engine pattern.

Port of ``repro.traversal``:

* ``semiring``: the ``Semiring`` abstraction (boolean / tropical min-plus /
  plus-times), the segmented reduction, the lane-batched semiring SpMV and
  the masked tropical gather-relax (the ``semiring_relax`` and
  ``relax_fallback`` kernels);
* ``sssp``: bucketed delta-stepping, many sources as dense float lanes
  streamed through the pipelined root queue;
* ``ref``: the numpy Dijkstra oracle.
"""
from repro_torch.traversal.ref import dijkstra_reference, to_numpy_weighted
from repro_torch.traversal.semiring import (BOOLEAN, PLUS_TIMES, SEMIRINGS,
                                            TROPICAL, Semiring,
                                            segment_reduce, semiring_spmv,
                                            tropical_relax)
from repro_torch.traversal.sssp import (DEFAULT_LANES, MAX_SSSP_STEPS,
                                        MAX_SSSP_TRACE, SSSPResult,
                                        adaptive_delta, default_delta,
                                        sssp_engine_drain,
                                        sssp_engine_enqueue, sssp_engine_idle,
                                        sssp_engine_init, sssp_engine_result,
                                        sssp_engine_step, sssp_pipelined)

__all__ = [
    "BOOLEAN", "DEFAULT_LANES", "MAX_SSSP_STEPS", "MAX_SSSP_TRACE",
    "PLUS_TIMES", "SEMIRINGS", "SSSPResult", "Semiring", "TROPICAL",
    "adaptive_delta", "default_delta", "dijkstra_reference",
    "segment_reduce", "semiring_spmv", "sssp_engine_drain",
    "sssp_engine_enqueue", "sssp_engine_idle", "sssp_engine_init",
    "sssp_engine_result", "sssp_engine_step", "sssp_pipelined",
    "to_numpy_weighted", "tropical_relax",
]
