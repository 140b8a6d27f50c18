"""engine_host_ms.sssp: milliseconds a request's lane engine spends on the
host's own work in the SSSP cell: the program's own ``sssp.step`` spans less
the blocking syncs inside them (``repro_torch.obs.spans``), summed over the
traced window's requests and divided by their number."""
import program_spans

read = program_spans.engine_host_ms
