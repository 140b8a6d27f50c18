"""entry_host_ms.depths: milliseconds a request spends on the host's own work
in the analytics entry in the depths cell, outside the drain and the parents:
the program's spans of the entry's phases (the engine's set-up, the result's
assembly) less the syncs inside them, summed over the traced window's requests
and divided by their number."""
import program_spans

read = program_spans.entry_host_ms
