"""CUDA wrapper for the fused top-down scan kernel (``csrc/topdown_scan.cu``).

Replaces ``repro/kernels/topdown_scan/kernel.py::topdown_scan_pallas`` and
the scatter-min after it (``repro/kernels/topdown_scan/ops.py``): returns
best int32[n], the min frontier source of each unvisited destination, or n.
The kernel reads only the frontier rows' slots, so it takes ``row_ptr``
where the reference takes ``src_idx``. The source file notes what bounds
the kernel on the H100 and how its design answers it: a list of the
frontier's rows, then their slots shared out in equal chunks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

_P = ctypes.c_void_p
_I = ctypes.c_int
_entry = None
MAX_VERTICES = 2 ** 28  # the list's counter packs the entry count in 28 bits


def frontier_scratch(n: int) -> int:
    """Bytes of the frontier list over ``n`` vertices: an 8-byte counter,
    then three int32 arrays of ``n`` entries (vertex, row start, offset)."""
    return 8 + 12 * n


def _launcher():
    global _entry
    if _entry is None:
        fn = common.load_library().topdown_scan_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I,
                       _I, _P]
        fn.restype = _I
        _entry = fn
    return _entry


def topdown_scan_cuda(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                      frontier_words: torch.Tensor,
                      visited_words: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the fused scan. row_ptr is a contiguous int32 CUDA tensor of
    n + 1 entries, col_idx of its m slots, the word arrays contiguous int32
    CUDA tensors, all on one device. Raises on anything else. Its scratch
    (``frontier_scratch``) comes from ``torch.empty``."""
    dev = row_ptr.device
    common.check_cuda_tensor("row_ptr", row_ptr, n + 1)
    common.check_cuda_tensor("col_idx", col_idx, device=dev)
    common.check_cuda_tensor("frontier_words", frontier_words, device=dev)
    common.check_cuda_tensor("visited_words", visited_words, device=dev)
    m = col_idx.numel()
    if n >= MAX_VERTICES or m >= 2 ** 31:
        raise ValueError(f"topdown_scan takes n < 2^28 and m < 2^31, got "
                         f"n={n}, m={m}")
    best = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return best
    scratch = torch.empty(frontier_scratch(n) // 4, dtype=torch.int32,
                          device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(row_ptr.data_ptr(), col_idx.data_ptr(),
                     frontier_words.data_ptr(), visited_words.data_ptr(),
                     best.data_ptr(), scratch.data_ptr(), m, n,
                     frontier_words.numel(), visited_words.numel(),
                     common.sm_count(dev),
                     torch.cuda.current_stream(dev).cuda_stream)
    common.check_launch("topdown_scan", err)
    common.LAUNCHES["topdown_scan"] += 1
    return best
