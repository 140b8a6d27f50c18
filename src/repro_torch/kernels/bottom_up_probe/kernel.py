"""CUDA wrapper for the bottom-up probe kernel (``csrc/bottom_up_probe.cu``).

Replaces ``repro/kernels/bottom_up_probe/kernel.py::bottom_up_probe_pallas``
with the same contract: (found int32[n], parent int32[n]). The kernel reads
each row's bounds from ``row_ptr`` where the reference takes starts and
degrees, and the step's bool ``unvisited`` as one byte a vertex where the
reference takes int32 flags. The source file notes what bounds the kernel
on the H100 and how its design answers it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

_P = ctypes.c_void_p
_I = ctypes.c_int
_entry = None


def _launcher():
    global _entry
    if _entry is None:
        fn = common.load_library().bottom_up_probe_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        fn.restype = _I
        _entry = fn
    return _entry


def bottom_up_probe_cuda(row_ptr: torch.Tensor, unvisited: torch.Tensor,
                         parent: torch.Tensor, col_idx: torch.Tensor,
                         frontier_words: torch.Tensor, max_pos: int = 8):
    """Launch the probe. row_ptr is int32[n + 1] (row v's slots start at
    row_ptr[v], and it has row_ptr[v + 1] - row_ptr[v] of them), unvisited
    bool[n], parent int32[n], col_idx int32[m], frontier_words int32 of
    ceil(nf/32) words, all contiguous and 1-D on one CUDA device. Raises on
    anything else."""
    if row_ptr.dim() != 1 or row_ptr.shape[0] < 1:
        raise ValueError("row_ptr must be 1-D with n + 1 >= 1 entries")
    n = row_ptr.shape[0] - 1
    dev = row_ptr.device
    common.check_cuda_tensor("row_ptr", row_ptr, n + 1, dev)
    common.check_cuda_tensor("unvisited", unvisited, n, dev, dtype=torch.bool)
    common.check_cuda_tensor("parent", parent, n, dev)
    common.check_cuda_tensor("col_idx", col_idx, device=dev)
    common.check_cuda_tensor("frontier_words", frontier_words, device=dev)
    found = torch.empty_like(parent)
    parent_out = torch.empty_like(parent)
    if n == 0:
        return found, parent_out
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(row_ptr.data_ptr(), unvisited.data_ptr(),
                     parent.data_ptr(), col_idx.data_ptr(),
                     frontier_words.data_ptr(), found.data_ptr(),
                     parent_out.data_ptr(), n, frontier_words.numel(),
                     int(max_pos), common.sm_count(dev),
                     torch.cuda.current_stream(dev).cuda_stream)
    common.check_launch("bottom_up_probe", err)
    common.LAUNCHES["bottom_up_probe"] += 1
    return found, parent_out
