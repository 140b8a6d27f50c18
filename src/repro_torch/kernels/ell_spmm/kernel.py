"""CUDA wrapper for the ELL-slab SpMM kernel (``csrc/ell_spmm.cu``).

Replaces ``repro/kernels/ell_spmm/kernel.py::ell_spmm_pallas`` with the same
contract: ``Y[i] = sum_k valid[i,k] * X[neigh[i,k]]``, float32[n, d]. The
source file notes what bounds the kernel on the H100 and how its design
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
        fn = common.load_library().ell_spmm_launch
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        _entry = fn
    return _entry


def ell_spmm_cuda(neigh: torch.Tensor, valid: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """Launch the slab sum. neigh int32[n, k_max], valid bool[n, k_max],
    x float32[n_src, d], all contiguous on one CUDA device; returns
    float32[n, d]. Raises on anything else."""
    if neigh.dim() != 2 or x.dim() != 2:
        raise ValueError("neigh and x must be 2-D")
    n, k_max = neigh.shape
    n_src, d = x.shape
    dev = neigh.device
    common.check_cuda_tensor("neigh", neigh, device=dev, width=k_max)
    common.check_cuda_tensor("valid", valid, n * k_max, dev, width=k_max,
                             dtype=torch.bool)
    common.check_cuda_tensor("x", x, device=dev, width=d,
                             dtype=torch.float32)
    if n_src == 0 or k_max == 0:
        return torch.zeros((n, d), dtype=torch.float32, device=dev)
    y = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n and d:
        launch = _launcher()
        with torch.cuda.device(dev):
            err = launch(neigh.data_ptr(), valid.data_ptr(), x.data_ptr(),
                         y.data_ptr(), n, n_src, d, k_max,
                         common.sm_count(dev),
                         torch.cuda.current_stream(dev).cuda_stream)
        common.check_launch("ell_spmm", err)
        common.LAUNCHES["ell_spmm"] += 1
    return y
