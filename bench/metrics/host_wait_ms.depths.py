"""host_wait_ms.depths: milliseconds a request's host spends blocked in the
program's sync spans (every read-back from the device, and every pageable
upload, anywhere in the sweep) in the depths cell, summed over the traced
window's requests and divided by their number."""
import program_spans

read = program_spans.host_wait_ms
