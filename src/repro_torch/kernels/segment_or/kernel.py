"""CUDA wrapper for the fused row-OR kernel (``csrc/segment_or.cu``).

Stands in for the XLA segmented-OR scan ``repro/core/packed.py::segment_or``
and the gathers and masks around it in both packed steps; no Pallas kernel
covers it. The source file notes what bounds the kernel on the H100 and how
its design answers it: rows of up to ``SEG`` slots in a warp's 32-row tile,
longer rows cut into ``SEG``-slot segments that a second launch ORs in.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

_P = ctypes.c_void_p
_I = ctypes.c_int
_entry = None
SEG = 256  # edge slots per segment of a long row


def segment_scratch(m: int) -> tuple[int, int]:
    """(segments, scratch bytes) of the long-row list over ``m`` edge
    slots: a row of c > SEG slots makes ceil(c / SEG) < 2 c / SEG segments,
    so at most ``2 * m // SEG + 1`` entries of two int32 (row, first slot),
    after an int32 count and an int32 of padding."""
    segments = 2 * m // SEG + 1
    return segments, 8 * (segments + 1)


def _launcher():
    global _entry
    if _entry is None:
        fn = common.load_library().segment_or_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       ctypes.c_longlong, _P, _I, _P]
        fn.restype = _I
        _entry = fn
    return _entry


def segment_or_rows_cuda(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                         frontier: torch.Tensor, mask: torch.Tensor,
                         sel: torch.Tensor | None = None,
                         base: torch.Tensor | None = None,
                         row_active: torch.Tensor | None = None,
                         min_pos: int = 0) -> torch.Tensor:
    """Launch the row-OR. row_ptr int32[n+1], col_idx int32[m], frontier
    int32[nf, W], mask (and base) int32[n, W], sel int32[W], row_active
    int32[n], all contiguous on one CUDA device; ``None`` means all lanes
    selected, a zero base, every row active. Raises on anything else. Its
    scratch (``segment_scratch``) comes from ``torch.empty``."""
    if mask.dim() != 2:
        raise ValueError("mask must be 2-D [n, W]")
    n, w = mask.shape
    dev = mask.device
    common.check_cuda_tensor("row_ptr", row_ptr, n + 1, dev)
    common.check_cuda_tensor("col_idx", col_idx, device=dev)
    common.check_cuda_tensor("frontier", frontier, device=dev, width=w)
    common.check_cuda_tensor("mask", mask, n * w, dev, width=w)
    if sel is not None:
        common.check_cuda_tensor("sel", sel, w, dev)
    if base is not None:
        common.check_cuda_tensor("base", base, n * w, dev, width=w)
    if row_active is not None:
        common.check_cuda_tensor("row_active", row_active, n, dev)
    nf = frontier.shape[0]
    if nf < 1 and col_idx.numel():
        raise ValueError("frontier has no rows")
    out = torch.empty_like(mask)
    if n == 0 or w == 0:
        return out
    segments, nbytes = segment_scratch(col_idx.numel())
    scratch = torch.empty(nbytes // 4, dtype=torch.int32, device=dev)
    launch = _launcher()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = launch(row_ptr.data_ptr(), col_idx.data_ptr(),
                     frontier.data_ptr(), mask.data_ptr(), ptr(sel),
                     ptr(base), ptr(row_active), out.data_ptr(), n, nf, w,
                     int(min_pos), SEG, segments, scratch.data_ptr(),
                     common.sm_count(dev),
                     torch.cuda.current_stream(dev).cuda_stream)
    common.check_launch("segment_or", err)
    common.LAUNCHES["segment_or"] += 1
    return out
