"""Architecture registry and step builder (port of
``repro/configs/base.py``).

Every ported architecture registers an ``Arch`` here; the trainer, the
launcher and the tests read this one interface. Ported so far: the GCN
family member ``gcn-cora`` and its training step (one microbatch). Every
other family, step kind or microbatch count raises ``NotImplementedError``
until its slice (ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.optim.adamw import (OptConfig, adamw_update,
                                     clip_by_global_norm)

_NOT_PORTED = "not ported yet (ROADMAP A10)"


@dataclass(frozen=True)
class Shape:
    shape_id: str
    kind: str                  # train | prefill | decode | serve | retrieval
    dims: dict


@dataclass(frozen=True)
class Arch:
    arch_id: str
    family: str                # lm-dense | lm-moe | gnn | recsys
    model_cfg: Any
    shapes: tuple[Shape, ...]
    opt: OptConfig = OptConfig()
    source: str = ""
    microbatches: int = 1

    def shape(self, shape_id: str) -> Shape:
        for s in self.shapes:
            if s.shape_id == shape_id:
                return s
        raise KeyError(f"{self.arch_id} has no shape {shape_id}")


REGISTRY: dict[str, Arch] = {}


def register(arch: Arch) -> Arch:
    REGISTRY[arch.arch_id] = arch
    return arch


def get_arch(arch_id: str) -> Arch:
    import repro_torch.configs.all  # noqa: F401  (populates REGISTRY)
    return REGISTRY[arch_id]


def list_archs() -> list[str]:
    import repro_torch.configs.all  # noqa: F401
    return sorted(REGISTRY)


def effective_cfg(arch: Arch, shape: Shape | None):
    """Per-shape config overrides: a GNN takes its input width and class
    count from the shape."""
    cfg = arch.model_cfg
    if shape is None or arch.family != "gnn":
        return cfg
    over = {}
    if "d_feat" in shape.dims:
        over["d_feat"] = shape.dims["d_feat"]
    if "n_classes" in shape.dims and hasattr(cfg, "n_classes"):
        over["n_classes"] = shape.dims["n_classes"]
    if hasattr(cfg, "task"):
        over["task"] = "graph" if shape.dims.get("n_graphs", 1) > 1 else "node"
    return dataclasses.replace(cfg, **over)


def param_builders(arch: Arch, shape: Shape | None = None):
    """Returns (init_fn(generator) -> params, loss_fn(params, batch))."""
    cfg = effective_cfg(arch, shape)
    if arch.family == "gnn" and type(cfg).__name__ == "GCNConfig":
        from repro_torch.models.gnn.gcn import gcn_loss, init_gcn
        return (lambda g: init_gcn(g, cfg)), (lambda p, b: gcn_loss(p, b, cfg))
    raise NotImplementedError(
        f"{arch.family} model {type(cfg).__name__} is {_NOT_PORTED}")


def make_step(arch: Arch, shape: Shape) -> Callable:
    """train: step(params, opt_state, batch) -> (params, opt_state, metrics),
    with gradients clipped by global norm and an AdamW update."""
    if shape.kind != "train":
        raise NotImplementedError(f"{shape.kind} steps are {_NOT_PORTED}")
    if arch.microbatches != 1:
        raise NotImplementedError(
            f"gradient accumulation over {arch.microbatches} microbatches "
            f"is {_NOT_PORTED}")
    _, loss_fn = param_builders(arch, shape)
    opt_cfg = arch.opt

    def train_step(params, opt_state, batch):
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss, metrics = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm)
        return params, opt_state, metrics
    return train_step
