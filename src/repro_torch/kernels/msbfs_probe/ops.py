"""Public wrapper for the msbfs_probe kernel.

``msbfs_probe`` is what ``repro_torch.core.packed.bottomup_packed_step``
calls, with the contract of ``repro/kernels/msbfs_probe/ops.py``: given the
packed frontier int32[nf, W] and need int32[n, W] lane words it returns the
probe's OR accumulator int32[n, W] (the caller masks it with ``need``). A
CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
PyTorch version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.msbfs_probe.kernel import msbfs_probe_cuda
from repro_torch.kernels.msbfs_probe.ref import msbfs_probe_ref


def msbfs_probe(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                frontier_words: torch.Tensor, need_words: torch.Tensor,
                max_pos: int = 8) -> torch.Tensor:
    """The kernel reads ``row_ptr`` as it is; the plain version takes the
    reference's starts and degrees, built from it."""
    if col_idx.device.type == "cuda":
        return msbfs_probe_cuda(row_ptr, need_words, col_idx, frontier_words,
                                max_pos)
    if col_idx.device.type == "cpu":
        return msbfs_probe_ref(row_ptr[:-1], row_ptr.diff(), need_words,
                               col_idx, frontier_words, max_pos)
    raise ValueError(f"no msbfs_probe for device {col_idx.device}")
