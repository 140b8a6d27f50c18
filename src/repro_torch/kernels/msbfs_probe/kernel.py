"""CUDA wrapper for the word-packed probe kernel (``csrc/msbfs_probe.cu``).

Replaces ``repro/kernels/msbfs_probe/kernel.py::msbfs_probe_pallas`` with
the same contract: acc int32[n, W], the OR of the first ``max_pos``
neighbours' frontier words per vertex and word plane, retired per plane.
The kernel reads each row's bounds from ``row_ptr`` where the reference
takes starts and degrees. The source file notes what bounds the kernel on
the H100 and how its design answers it.
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
        fn = common.load_library().msbfs_probe_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I,
                       _I, _P]
        fn.restype = _I
        _entry = fn
    return _entry


def msbfs_probe_cuda(row_ptr: torch.Tensor, need_words: torch.Tensor,
                     col_idx: torch.Tensor, frontier_words: torch.Tensor,
                     max_pos: int = 8) -> torch.Tensor:
    """Launch the probe. row_ptr is int32[n + 1] (row v's slots start at
    row_ptr[v], and it has row_ptr[v + 1] - row_ptr[v] of them),
    need_words int32[n, W], col_idx int32[m], frontier_words int32[nf, W]
    (nf may differ from n: a 2-D block's rows probe its column block's
    frontier slice), all contiguous on one CUDA device. Raises on anything
    else."""
    if need_words.dim() != 2:
        raise ValueError("need_words must be 2-D [n, W]")
    n, w = need_words.shape
    dev = row_ptr.device
    common.check_cuda_tensor("row_ptr", row_ptr, n + 1, dev)
    common.check_cuda_tensor("need_words", need_words, n * w, dev, width=w)
    common.check_cuda_tensor("col_idx", col_idx, device=dev)
    common.check_cuda_tensor("frontier_words", frontier_words, device=dev,
                             width=w)
    nf = frontier_words.shape[0]
    m = col_idx.numel()
    if nf < 1 and m:
        raise ValueError("frontier_words has no rows")
    acc = torch.empty_like(need_words)  # the kernel writes every word
    if n == 0 or w == 0:
        return acc
    if m == 0:  # no row has a slot: nothing is gathered
        return acc.zero_()
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(row_ptr.data_ptr(), need_words.data_ptr(),
                     col_idx.data_ptr(), frontier_words.data_ptr(),
                     acc.data_ptr(), n, nf, w, m, int(max_pos),
                     common.sm_count(dev),
                     torch.cuda.current_stream(dev).cuda_stream)
    common.check_launch("msbfs_probe", err)
    common.LAUNCHES["msbfs_probe"] += 1
    return acc
