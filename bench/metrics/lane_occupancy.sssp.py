"""lane_occupancy.sssp: the share of the lane pool that carries a live
traversal, in %, over every engine step of the traced window's requests in the
SSSP cell (the program's ``lanes_live`` and ``lanes_pool`` counters)."""
import program_spans

read = program_spans.lane_occupancy
