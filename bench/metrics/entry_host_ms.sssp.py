"""entry_host_ms.sssp: milliseconds a request spends on the host's own work in
the analytics entry in the SSSP cell, outside the drain: the program's spans of
the entry's phases (the engine's set-up, the bucket width, the result's
assembly) less the syncs inside them, summed over the traced window's requests
and divided by their number."""
import program_spans

read = program_spans.entry_host_ms
