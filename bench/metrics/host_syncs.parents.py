"""host_syncs.parents: blocking transfers between the host and the device a
request makes in the parents cell (the program's ``host_syncs`` counter: each
read-back and each pageable upload), over the traced window's requests."""
import program_spans

read = program_spans.host_syncs
