"""relax_fallback_roofline: X2's CUDA kernel as a share of its roofline in
the traced window, in %: the least time the launches' work needs
(``costs.relax_fallback_launch``, counted from each launch's arguments
in a pass of its own over the same requests) over the kernels' device
time under the profiler, summed by name."""
import costs

COUNTS = {
    "relax_fallback": ("repro_torch.traversal.semiring:relax_fallback",
                       costs.relax_fallback_launch),
}
KERNELS = (
    "relax_fallback_kernel",
)


def read(t):
    return costs.roofline_pct(t, "relax_fallback", KERNELS)
