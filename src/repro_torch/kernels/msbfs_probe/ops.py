"""Public wrapper for the msbfs_probe kernel.

``msbfs_probe`` is what ``repro_torch.core.packed.bottomup_packed_step``
calls, with the contract of ``repro/kernels/msbfs_probe/ops.py``: given the
packed frontier [nf, W] and need [n, W] lane words it returns the probe's
OR accumulator [n, W] (the caller masks it with ``need``), in the words'
dtype. A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain PyTorch version.

64-bit words (int64) take the reference's u64 gather path on both routes:
the kernel and the plain version run on their int32 view, 2W half-word
planes retired one by one, and the result is viewed back. So the
accumulator equals the reference's bit for bit even unmasked.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import word_planes
from repro_torch.kernels.msbfs_probe.kernel import msbfs_probe_cuda
from repro_torch.kernels.msbfs_probe.ref import msbfs_probe_ref


def msbfs_probe(row_ptr: torch.Tensor, col_idx: torch.Tensor,
                frontier_words: torch.Tensor, need_words: torch.Tensor,
                max_pos: int = 8) -> torch.Tensor:
    """The kernel reads ``row_ptr`` as it is; the plain version takes the
    reference's starts and degrees, built from it."""
    need, frontier = word_planes(need_words), word_planes(frontier_words)
    if col_idx.device.type == "cuda":
        acc = msbfs_probe_cuda(row_ptr, need, col_idx, frontier, max_pos)
    elif col_idx.device.type == "cpu":
        acc = msbfs_probe_ref(row_ptr[:-1], row_ptr.diff(), need, col_idx,
                              frontier, max_pos)
    else:
        raise ValueError(f"no msbfs_probe for device {col_idx.device}")
    return acc.view(need_words.dtype)
