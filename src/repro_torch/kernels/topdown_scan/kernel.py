"""CUDA wrapper for the fused top-down scan kernel (``csrc/topdown_scan.cu``).

Replaces ``repro/kernels/topdown_scan/kernel.py::topdown_scan_pallas`` and
the scatter-min after it (``repro/kernels/topdown_scan/ops.py``): returns
best int32[n], the min frontier source of each unvisited destination, or n.
The source file notes what bounds the kernel on the H100 and how its design
answers it.
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
        fn = common.load_library().topdown_scan_launch
        fn.argtypes = [_P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I,
                       _P]
        fn.restype = _I
        _entry = fn
    return _entry


def topdown_scan_cuda(src_idx: torch.Tensor, col_idx: torch.Tensor,
                      frontier_words: torch.Tensor,
                      visited_words: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the fused scan. src_idx/col_idx are contiguous int32 CUDA
    tensors of m edge slots, the word arrays contiguous int32 CUDA tensors,
    all on one device. Raises on anything else."""
    m = src_idx.numel()
    dev = src_idx.device
    common.check_cuda_tensor("src_idx", src_idx)
    common.check_cuda_tensor("col_idx", col_idx, m, dev)
    common.check_cuda_tensor("frontier_words", frontier_words, device=dev)
    common.check_cuda_tensor("visited_words", visited_words, device=dev)
    best = torch.empty(n, dtype=torch.int32, device=dev)
    best.fill_(n)
    if m == 0 or n == 0:
        return best
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(src_idx.data_ptr(), col_idx.data_ptr(),
                     frontier_words.data_ptr(), visited_words.data_ptr(),
                     best.data_ptr(), m, n, frontier_words.numel(),
                     visited_words.numel(), common.sm_count(dev),
                     torch.cuda.current_stream(dev).cuda_stream)
    common.check_launch("topdown_scan", err)
    common.LAUNCHES["topdown_scan"] += 1
    return best
