"""host_syncs.sssp: blocking transfers between the host and the device a
request makes in the SSSP cell (the program's ``host_syncs`` counter: each
read-back and each pageable upload), over the traced window's requests."""
import program_spans

read = program_spans.host_syncs
