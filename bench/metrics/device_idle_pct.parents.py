"""device_idle_pct.parents: the share of the traced window, in %, in which
no operation ran on the device (kernels, copies and fills, from the
profiler's device events), in the parents cell."""
import profiling

read = profiling.idle_pct
