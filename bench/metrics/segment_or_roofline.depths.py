"""segment_or_roofline.depths: X1's CUDA kernels (the row pass and the
segment pass) in the depths cell as a share of its roofline in the
traced window, in %: the least time the launches' work needs
(``costs.segment_or_launch``, counted from each launch's arguments in a
pass of its own over the same requests) over the kernels' device time
under the profiler, summed by name."""
import costs

COUNTS = {
    "segment_or": ("repro_torch.core.packed:segment_or_rows",
                   costs.segment_or_launch),
}
KERNELS = (
    "segment_or_rows_kernel",
    "segment_or_segments_kernel",
)


def read(t):
    return costs.roofline_pct(t, "segment_or", KERNELS)
