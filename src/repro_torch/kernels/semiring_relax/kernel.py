"""CUDA wrapper for the min-plus gather-relax kernel
(``csrc/semiring_relax.cu``).

Replaces ``repro/kernels/semiring_relax/kernel.py::semiring_relax_pallas``
with the same contract: acc float32[n, L], the min over each row's first
``max_pos`` neighbours of ``vals[neighbour] + weight``. The source file
notes what bounds the kernel on the H100 and how its design answers it.
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
        fn = common.load_library().semiring_relax_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _I,
                       _I, _P]
        fn.restype = _I
        _entry = fn
    return _entry


def semiring_relax_cuda(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                        weights: torch.Tensor, vals: torch.Tensor,
                        max_pos: int = 8) -> torch.Tensor:
    """Launch the relax. row_ptr is int32[n + 1] (row v's slots start at
    row_ptr[v], and it has row_ptr[v + 1] - row_ptr[v] of them), col_idx
    int32[m], weights float32[m], vals float32[nf, L] (or float32[nf] as
    L = 1, returned flat; nf may differ from n: a 2-D block's rows relax
    against its column block's values), all contiguous on one CUDA device;
    the kernel maps a thread or a warp to vertices as L asks. Raises on
    anything else."""
    flat = vals.dim() == 1
    v2 = vals[:, None] if flat else vals
    if v2.dim() != 2:
        raise ValueError("vals must be 1-D or 2-D [nf, L]")
    if row_ptr.dim() != 1 or row_ptr.shape[0] < 1:
        raise ValueError("row_ptr must be 1-D with n + 1 >= 1 entries")
    n = row_ptr.shape[0] - 1
    nf, lanes = v2.shape
    dev = row_ptr.device
    common.check_cuda_tensor("row_ptr", row_ptr, n + 1, dev)
    common.check_cuda_tensor("col_idx", col_idx, device=dev)
    m = col_idx.numel()
    common.check_cuda_tensor("weights", weights, m, dev, dtype=torch.float32)
    common.check_cuda_tensor("vals", v2, device=dev, width=lanes,
                             dtype=torch.float32)
    if nf < 1 and m:
        raise ValueError("vals has no rows")
    acc = torch.empty((n, lanes), dtype=torch.float32, device=dev)
    if m == 0:
        acc.fill_(float("inf"))
    elif n and lanes:
        launch = _launcher()
        with torch.cuda.device(dev):
            err = launch(row_ptr.data_ptr(), col_idx.data_ptr(),
                         weights.data_ptr(), v2.data_ptr(), acc.data_ptr(), n,
                         nf, lanes, m, int(max_pos), common.sm_count(dev),
                         torch.cuda.current_stream(dev).cuda_stream)
        common.check_launch("semiring_relax", err)
        common.LAUNCHES["semiring_relax"] += 1
    return acc[:, 0] if flat else acc
