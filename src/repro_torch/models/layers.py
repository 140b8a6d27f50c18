"""Shared functional layers (port of ``repro/models/layers.py``): what the
GNN and recsys models use, the dense layer, the plain MLP and the masked
cross-entropy.

Pure functions over dicts of tensors. Initial values come from an explicit
``torch.Generator``: they follow the reference's distributions, not its
values (JAX's threefry stream is not reproduced), so the tests carry the
reference's parameters across.
"""
from __future__ import annotations

import numpy as np
import torch


def _dense_init(gen: torch.Generator, shape, dtype, scale=None):
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(max(1, fan_in))
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def dense(gen: torch.Generator, d_in: int, d_out: int,
          dtype=torch.float32, bias: bool = False) -> dict:
    """{"w": [d_in, d_out] normal * 1/sqrt(d_in)} (+ {"b": zeros})."""
    params = {"w": _dense_init(gen, (d_in, d_out), dtype)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return params


def apply_dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32) -> list:
    """Plain MLP used by GNN and recsys heads, sizes = [d0, d1, ..., dk]:
    a list of {"w", "b"} dense layers."""
    return [dense(gen, sizes[i], sizes[i + 1], dtype, bias=True)
            for i in range(len(sizes) - 1)]


_ACTS = {"relu": torch.relu,
         "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
         "silu": torch.nn.functional.silu, "tanh": torch.tanh,
         "sigmoid": torch.sigmoid}


def apply_mlp(params: list, x: torch.Tensor, act: str = "relu",
              final_act: str | None = None) -> torch.Tensor:
    """``act`` between the layers, ``final_act`` (if any) after the last."""
    a = _ACTS[act]
    for i, p in enumerate(params):
        x = apply_dense(p, x)
        if i < len(params) - 1:
            x = a(x)
        elif final_act is not None:
            x = _ACTS[final_act](x)
    return x


def softmax_xent(logits, labels, mask=None) -> torch.Tensor:
    """Mean cross-entropy in float32. logits [..., V], labels int[...]."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
