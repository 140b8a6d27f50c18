"""Hand-written CUDA kernels, each beside its plain PyTorch version.

One folder per kernel, as in ``repro.kernels``: ``kernel.py`` launches the
CUDA source from ``repro_torch/csrc/``, ``ref.py`` is the plain version,
``ops.py`` is the wrapper the engines and models call. The GNN aggregation
and its plain versions are re-exported here, as the reference's package
exports them; nothing here builds or loads a kernel at import time.
"""
from repro_torch.kernels.ell_spmm.ops import spmm_aggregate
from repro_torch.kernels.ell_spmm.ref import ell_spmm_ref
from repro_torch.kernels.spmm_residue.ref import spmm_residue_ref

__all__ = ["ell_spmm_ref", "spmm_aggregate", "spmm_residue_ref"]
