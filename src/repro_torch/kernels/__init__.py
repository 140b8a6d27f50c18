"""Hand-written CUDA kernels, each beside its plain PyTorch version.

One folder per kernel, as in ``repro.kernels``: ``kernel.py`` launches the
CUDA source from ``repro_torch/csrc/``, ``ref.py`` is the plain version,
``ops.py`` is the wrapper the BFS steps call. Callers import from those
modules; nothing here builds or loads a kernel at import time.
"""
