"""CUDA wrapper for the residue fold of the ELL sum aggregation
(``csrc/spmm_residue.cu``).

Stands in for the XLA ``segment_sum`` tail of
``repro/kernels/ell_spmm/ops.py::spmm_aggregate`` (lines 28-31); no Pallas
kernel covers it. The source file notes what bounds the kernel on the H100
and how its design answers it: a fold over fixed segments of ``SEG`` slots,
then a merge of the rows split across segments, in segment order.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

_P = ctypes.c_void_p
_I = ctypes.c_int
_entry = None
SEG = 1024  # edge slots per segment of the fold


def residue_scratch(m: int, d: int) -> tuple[int, int]:
    """(segments, scratch bytes) of the fold over ``m`` edge slots at width
    ``d``: ``segments = ceil(m / SEG)``; the scratch is 2 * segments * d
    float32 partial sums and one int32 row number a segment."""
    segments = common.cdiv(m, SEG)
    return segments, 4 * (2 * segments * d + segments)


def residue_launches(d: int) -> int:
    """Kernels one fold launches at width ``d`` (with n, m and the source
    rows all > 0), as ``spmm_residue_launch`` reckons them: a row and a
    segment pass per block of up to 4 * S columns, S = min(32, pow2 >= d),
    then the merge."""
    sub = 1
    while sub < d and sub < 32:
        sub *= 2
    return 2 * common.cdiv(d, sub * min(common.cdiv(d, sub), 4)) + 1


def _launcher():
    global _entry
    if _entry is None:
        fn = common.load_library().spmm_residue_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       ctypes.c_longlong, _I, _I, _P,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = _I
        _entry = fn
    return _entry


def spmm_residue_cuda(row_ptr: torch.Tensor, src_idx: torch.Tensor,
                      col_idx: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                      k_max: int = 16) -> torch.Tensor:
    """Launch the residue fold, which adds each row's slots at positions
    >= k_max into ``y`` in place and returns it. row_ptr int32[n+1],
    src_idx and col_idx int32[m], x float32[n_src, d], y float32[n, d],
    all contiguous on one CUDA device. Raises on anything else. Its
    scratch (``residue_scratch``) comes from ``torch.empty``. Adds to the
    launch count the kernels the C entry reports it launched
    (``residue_launches(d)`` of them)."""
    if x.dim() != 2 or y.dim() != 2:
        raise ValueError("x and y must be 2-D")
    n, d = y.shape
    n_src = x.shape[0]
    dev = y.device
    common.check_cuda_tensor("row_ptr", row_ptr, n + 1, dev)
    common.check_cuda_tensor("col_idx", col_idx, device=dev)
    m = col_idx.numel()
    common.check_cuda_tensor("src_idx", src_idx, m, dev)
    common.check_cuda_tensor("x", x, device=dev, width=d,
                             dtype=torch.float32)
    common.check_cuda_tensor("y", y, n * d, dev, width=d,
                             dtype=torch.float32)
    if n == 0 or d == 0 or n_src == 0 or m == 0:
        return y
    segments, _ = residue_scratch(m, d)
    part = torch.empty(2 * segments * d, dtype=torch.float32, device=dev)
    part_row = torch.empty(segments, dtype=torch.int32, device=dev)
    launch = _launcher()
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = launch(row_ptr.data_ptr(), src_idx.data_ptr(),
                     col_idx.data_ptr(), x.data_ptr(), y.data_ptr(),
                     part.data_ptr(), part_row.data_ptr(), n, n_src, d,
                     int(k_max), segments, SEG, common.sm_count(dev),
                     torch.cuda.current_stream(dev).cuda_stream,
                     ctypes.byref(launched))
    common.LAUNCHES["spmm_residue"] += launched.value
    common.check_launch("spmm_residue", err)
    return y
