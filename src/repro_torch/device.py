"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Without one this raises: the port never moves
    to the CPU on its own; a caller that wants the plain PyTorch path passes
    ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch runs on the GPU "
                "by default; pass device='cpu' for the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def device_name(device) -> str:
    """Name of the device a result was computed on."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
