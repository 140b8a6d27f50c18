"""CUDA wrapper for the residue fold of the tropical relax
(``csrc/relax_fallback.cu``).

Stands in for the reference's ``_relax_fallback`` and the tropical
``segment_reduce`` (an XLA ``associative_scan``) it runs
(``repro/traversal/semiring.py:120-131``); no Pallas kernel covers it. The
source file notes what bounds the kernel on the H100 and how its design
answers it: fixed segments of slots, each row's residue read 32 weights a
round and only its live slots gathered.
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
        fn = common.load_library().relax_fallback_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong,
                       _I, _I, _P]
        fn.restype = _I
        _entry = fn
    return _entry


def relax_fallback_cuda(row_ptr: torch.Tensor, src_idx: torch.Tensor,
                        col_idx: torch.Tensor, weights: torch.Tensor,
                        vals: torch.Tensor, base: torch.Tensor,
                        max_pos: int = 8) -> torch.Tensor:
    """Launch the residue fold, which updates ``base`` in place to
    min(base, residue offers) and returns it. row_ptr int32[n+1], src_idx
    and col_idx int32[m], weights float32[m], vals float32[nf, L] (nf may
    differ from n, as on a 2-D block), base float32[n, L], all contiguous
    on one CUDA device. Raises on anything else."""
    if base.dim() != 2 or vals.dim() != 2:
        raise ValueError("base and vals must be 2-D [rows, L]")
    n, lanes = base.shape
    dev = base.device
    common.check_cuda_tensor("row_ptr", row_ptr, n + 1, dev)
    common.check_cuda_tensor("col_idx", col_idx, device=dev)
    m = col_idx.numel()
    common.check_cuda_tensor("src_idx", src_idx, m, dev)
    common.check_cuda_tensor("weights", weights, m, dev, dtype=torch.float32)
    common.check_cuda_tensor("vals", vals, device=dev, width=lanes,
                             dtype=torch.float32)
    common.check_cuda_tensor("base", base, n * lanes, dev, width=lanes,
                             dtype=torch.float32)
    nf = vals.shape[0]
    if nf < 1 and m:
        raise ValueError("vals has no rows")
    if n == 0 or lanes == 0 or m == 0:
        return base
    launch = _launcher()
    with torch.cuda.device(dev):
        err = launch(row_ptr.data_ptr(), src_idx.data_ptr(),
                     col_idx.data_ptr(), weights.data_ptr(), vals.data_ptr(),
                     base.data_ptr(), n, nf, lanes, m, int(max_pos),
                     common.sm_count(dev),
                     torch.cuda.current_stream(dev).cuda_stream)
    common.check_launch("relax_fallback", err)
    common.LAUNCHES["relax_fallback"] += 1
    return base
