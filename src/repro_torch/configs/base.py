"""Architecture registry and step builder (port of
``repro/configs/base.py``).

Every ported architecture registers an ``Arch`` here; the trainer, the
launcher and the tests read this one interface: the five LMs
(``phi4-mini-3.8b``, ``qwen1.5-32b``, ``llama3-405b``,
``granite-moe-1b-a400m``, ``qwen3-moe-30b-a3b``), the four GNNs
(``gcn-cora``, ``gin-tu``, ``egnn``, ``mace``) and DIEN (``dien``), with
the train step (gradient accumulation over microbatches too), the LM
prefill and decode steps, the GNN forward-only serve step, and DIEN's serve
and retrieval steps. The reference's shape and spec builders for its
dry-run (``param_shapes``, ``input_specs``, ``step_arg_specs``) are not
ported (ROADMAP A10 (f)).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.optim.adamw import (OptConfig, adamw_update,
                                     clip_by_global_norm)


@dataclass(frozen=True)
class Shape:
    shape_id: str
    kind: str                  # train | prefill | decode | serve | retrieval
    dims: dict
    skip_reason: str | None = None


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


# model config class -> (module under repro_torch.models, init, loss)
_MODELS = {"LMConfig": ("transformer", "init_lm", "lm_loss"),
           "GCNConfig": ("gnn.gcn", "init_gcn", "gcn_loss"),
           "GINConfig": ("gnn.gin", "init_gin", "gin_loss"),
           "EGNNConfig": ("gnn.egnn", "init_egnn", "egnn_loss"),
           "MACEConfig": ("gnn.mace", "init_mace", "mace_loss"),
           "DIENConfig": ("recsys.dien", "init_dien", "dien_loss")}


def param_builders(arch: Arch, shape: Shape | None = None):
    """Returns (init_fn(generator) -> params, loss_fn(params, batch))."""
    cfg = effective_cfg(arch, shape)
    path, init, loss = _MODELS[type(cfg).__name__]
    mod = importlib.import_module(f"repro_torch.models.{path}")
    init, loss = getattr(mod, init), getattr(mod, loss)
    return (lambda g: init(g, cfg)), (lambda p, b: loss(p, b, cfg))


def _microbatches(batch: dict, k: int):
    """Microbatch i of a dict batch: rows [i * B / k, (i + 1) * B / k) of
    every tensor (B must divide by k, as the reference's reshape needs)."""
    split = {key: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
             for key, v in batch.items()}
    return [{key: v[i] for key, v in split.items()} for i in range(k)]


def make_step(arch: Arch, shape: Shape) -> Callable:
    """The function the trainer and the serving launcher execute:

    train:     step(params, opt_state, batch) -> (params, opt_state,
               metrics), gradients clipped by global norm and an AdamW
               update; with ``arch.microbatches`` k > 1 the gradient is the
               sum of the k microbatches' gradients over k, accumulated in
               ``opt.accum_dtype`` in microbatch order, and the metrics are
               the mean loss and the grad norm, as the reference's;
    prefill:   step(params, batch) -> (last token's logits [B, V], cache),
               from ``batch["tokens"]`` (LM);
    decode:    step(params, batch) -> (logits [B, V], cache): one token
               ``batch["token"]`` [B, 1] written into the cache
               (``batch["cache_k"]``, ``batch["cache_v"]``) at slot
               ``batch["cache_len"]``, in place (LM);
    serve:     step(params, batch) -> CTR probabilities [B] (recsys), or
               the loss's metrics of a forward pass (GNN);
    retrieval: step(params, batch) -> top-100 candidate ids [B, 100].

    Prefill, decode, serve and retrieval steps run under
    ``torch.inference_mode()``.
    """
    cfg = effective_cfg(arch, shape)
    _, loss_fn = param_builders(arch, shape)

    if shape.kind == "train":
        opt_cfg = arch.opt
        k = max(1, arch.microbatches)

        def grads_of(params, batch):
            leaves = {n: p.detach().requires_grad_(True)
                      for n, p in params.items()}
            loss, metrics = loss_fn(leaves, batch)
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
            grads = {n: torch.zeros_like(p) if g is None else g
                     for (n, p), g in zip(leaves.items(), got)}
            return loss.detach(), metrics, grads

        def train_step(params, opt_state, batch):
            if k > 1:
                acc_dt = getattr(torch, opt_cfg.accum_dtype)
                grads = {n: torch.zeros(p.shape, dtype=acc_dt,
                                        device=p.device)
                         for n, p in params.items()}
                losses = []
                for mb in _microbatches(batch, k):
                    loss, _, g = grads_of(params, mb)
                    grads = {n: a + (g[n] / k).to(acc_dt)
                             for n, a in grads.items()}
                    losses.append(loss)
                loss = torch.stack(losses).mean()
                metrics = {}
            else:
                loss, metrics, grads = grads_of(params, batch)
                metrics = {n: v.detach() for n, v in metrics.items()}
            grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
            params, opt_state = adamw_update(params, grads, opt_state,
                                             opt_cfg)
            metrics.update(loss=loss, grad_norm=gnorm)
            return params, opt_state, metrics
        return train_step

    if shape.kind == "prefill":
        from repro_torch.models.transformer import lm_prefill

        @torch.inference_mode()
        def prefill_step(params, batch):
            return lm_prefill(params, batch["tokens"], cfg)
        return prefill_step

    if shape.kind == "decode":
        from repro_torch.models.transformer import lm_decode_step

        @torch.inference_mode()
        def decode_step(params, batch):
            return lm_decode_step(params, batch["token"],
                                  (batch["cache_k"], batch["cache_v"]),
                                  batch["cache_len"], cfg)
        return decode_step

    if shape.kind == "serve":
        if arch.family == "recsys":
            from repro_torch.models.recsys.dien import dien_forward

            @torch.inference_mode()
            def serve_step(params, batch):
                return torch.sigmoid(dien_forward(params, batch, cfg))
            return serve_step

        @torch.inference_mode()
        def fwd_step(params, batch):   # GNN forward-only
            _, metrics = loss_fn(params, batch)
            return metrics
        return fwd_step

    if shape.kind == "retrieval":
        from repro_torch.models.recsys.dien import dien_retrieval

        @torch.inference_mode()
        def retrieval_step(params, batch):
            _, top = dien_retrieval(params, batch, cfg)
            return top
        return retrieval_step

    raise ValueError(shape.kind)
