"""semiring_relax_roofline: B4's CUDA kernels (the warp-list and the
thread-per-vertex mapping) as a share of its roofline in the traced
window, in %: the least time the launches' work needs
(``costs.semiring_relax_launch``, counted from each launch's arguments
in a pass of its own over the same requests) over the kernels' device
time under the profiler, summed by name."""
import costs

COUNTS = {
    "semiring_relax": ("repro_torch.traversal.semiring:semiring_relax",
                       costs.semiring_relax_launch),
}
KERNELS = (
    "relax_list_kernel",
    "relax_thread_kernel",
)


def read(t):
    return costs.roofline_pct(t, "semiring_relax", KERNELS)
