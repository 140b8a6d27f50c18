"""CUDA wrapper for the parent derivation kernel (``csrc/derive_parents.cu``).

Stands in for the XLA gathers and scatter-min of
``repro/core/msbfs.py::_derive_parents``; no Pallas kernel covers it. Two
launches: ``narrow_depths_cuda`` writes the depths one byte a lane, and
``scan_parents_cuda`` gives each row's slots to a warp, which compares its
neighbours' bytes with the row's own depth less one and keeps a min per
lane. The source file notes what bounds the kernel on the H100 and how its
design answers it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

_P = ctypes.c_void_p
_I = ctypes.c_int
_entries: dict = {}
SEG = 256        # edge slots per segment of a long row
MAX_DEPTH = 253  # the largest depth a byte holds next to -1 and the no-target


def narrow_stride(r: int) -> int:
    """Bytes of a narrowed row of ``r`` lanes: 16, 32 or 64, or a multiple
    of 128 (the kernel's lane blocks of 4, 8, 16 or 32 threads)."""
    if r <= 64:
        return max(16, 1 << max(r - 1, 0).bit_length())
    return common.cdiv(r, 128) * 128


def segment_scratch(m: int) -> tuple[int, int]:
    """(segments, scratch bytes) of the long-row list over ``m`` edge
    slots: a row of c > SEG slots lists ceil(c / SEG) - 1 < c / SEG
    segments, so at most ``m // SEG + 1`` entries of two int32 (row, first
    slot), after an int32 count and an int32 of padding."""
    segments = m // SEG + 1
    return segments, 8 * (segments + 1)


def _launcher(name: str, argtypes):
    if name not in _entries:
        fn = getattr(common.load_library(), name)
        fn.argtypes = argtypes
        fn.restype = _I
        _entries[name] = fn
    return _entries[name]


def narrow_depths_cuda(depth: torch.Tensor) -> torch.Tensor:
    """depth int32[n, R], contiguous on a CUDA device, as uint8[n, stride]
    (``narrow_stride(R)``): lane l's byte is its depth's low byte, exact for
    depths in [-1, MAX_DEPTH]; pad lanes read 0xff (-1). Raises on anything
    else."""
    if depth.dim() != 2:
        raise ValueError("depth must be 2-D [n, R]")
    n, r = depth.shape
    common.check_cuda_tensor("depth", depth, width=r)
    dev = depth.device
    out = torch.empty((n, narrow_stride(r)), dtype=torch.uint8, device=dev)
    launch = _launcher("derive_parents_narrow_launch",
                       [_P, _P, ctypes.c_longlong, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        err = launch(depth.data_ptr(), out.data_ptr(), n, r, out.shape[1],
                     common.sm_count(dev),
                     torch.cuda.current_stream(dev).cuda_stream)
    common.check_launch("derive_parents", err)
    common.LAUNCHES["derive_parents"] += 1
    return out


def scan_parents_cuda(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                      narrow: torch.Tensor, r: int,
                      base: int = 0) -> torch.Tensor:
    """Parents int32[n_loc, r] of rows [base, base + n_loc) (n_loc =
    ``row_ptr``'s rows) from ``narrow_depths_cuda``'s uint8[n, stride]:
    the min neighbour u < n one level up in each lane, -1 where none is.
    row_ptr int32[n_loc + 1] and col_idx int32[m], contiguous on the same
    CUDA device. Raises on anything else. Its scratch (``segment_scratch``)
    comes from ``torch.empty``."""
    if narrow.dim() != 2:
        raise ValueError("narrow must be 2-D [n, stride]")
    n, stride = narrow.shape
    dev = narrow.device
    common.check_cuda_tensor("narrow", narrow, device=dev, width=stride,
                             dtype=torch.uint8)
    if stride != narrow_stride(r):
        raise ValueError(f"narrow must have {narrow_stride(r)} bytes a row "
                         f"for {r} lanes, got {stride}")
    n_loc = row_ptr.shape[0] - 1
    common.check_cuda_tensor("row_ptr", row_ptr, device=dev)
    common.check_cuda_tensor("col_idx", col_idx, device=dev)
    if n_loc < 0 or not 0 <= base <= n - n_loc:
        raise ValueError(f"rows [{base}, {base + n_loc}) must lie in the "
                         f"{n} rows of the depths")
    out = torch.empty((n_loc, r), dtype=torch.int32, device=dev)
    if n_loc == 0 or r == 0:
        return out
    segments, nbytes = segment_scratch(col_idx.numel())
    scratch = torch.empty(nbytes // 4, dtype=torch.int32, device=dev)
    launch = _launcher("derive_parents_scan_launch",
                       [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        ctypes.c_longlong, _P, _I, _P])
    with torch.cuda.device(dev):
        err = launch(row_ptr.data_ptr(), col_idx.data_ptr(),
                     narrow.data_ptr(), out.data_ptr(), n_loc, n, int(base),
                     r, stride, SEG, segments, scratch.data_ptr(),
                     common.sm_count(dev),
                     torch.cuda.current_stream(dev).cuda_stream)
    common.check_launch("derive_parents", err)
    common.LAUNCHES["derive_parents"] += 1
    return out
