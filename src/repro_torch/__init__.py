"""PyTorch/CUDA port of the hybrid-BFS reproduction.

Mirrors the layout and function names of the JAX package ``repro`` (the
reference it is tested against) without importing it: ``core/`` holds the
bitmap, CSR and BFS steps, ``graph/`` the Graph500 generator, validator and
harness, ``kernels/`` the hand-written CUDA kernels with their plain PyTorch
versions, ``launch/`` the command-line entry point.

Entry points run on the GPU unless the caller passes ``device="cpu"``; a
CUDA tensor always goes through the CUDA kernel, a CPU tensor through the
kernel's plain PyTorch version.
"""
from repro_torch.device import device_name, resolve_device

__all__ = ["device_name", "resolve_device"]
