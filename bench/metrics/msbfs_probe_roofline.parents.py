"""msbfs_probe_roofline.parents: B3's CUDA kernel in the parents cell as a
share of its roofline in the traced window, in %: the least time the
launches' work needs (``costs.msbfs_probe_launch``, counted from each
launch's arguments in a pass of its own over the same requests) over the
kernels' device time under the profiler, summed by name."""
import costs

COUNTS = {
    "msbfs_probe": ("repro_torch.core.packed:msbfs_probe",
                    costs.msbfs_probe_launch),
}
KERNELS = (
    "msbfs_probe_kernel",
)


def read(t):
    return costs.roofline_pct(t, "msbfs_probe", KERNELS)
