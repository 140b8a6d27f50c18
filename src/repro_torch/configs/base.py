"""Architecture registry, input-spec builders and step builder (port of
``repro/configs/base.py``).

Every ported architecture registers an ``Arch`` here; the trainer, the
launcher, the dry-run and the tests read this one interface: the five LMs
(``phi4-mini-3.8b``, ``qwen1.5-32b``, ``llama3-405b``,
``granite-moe-1b-a400m``, ``qwen3-moe-30b-a3b``), the four GNNs
(``gcn-cora``, ``gin-tu``, ``egnn``, ``mace``) and DIEN (``dien``), with
the train step (gradient accumulation over microbatches too), the LM
prefill and decode steps, the GNN forward-only serve step, and DIEN's serve
and retrieval steps.

``param_shapes``, ``input_specs`` and ``step_arg_specs`` give a step's
arguments as meta tensors (shape and dtype, nothing allocated) beside
their logical axis names, the reference's ``ShapeDtypeStruct`` trees and
spec trees: a flat dict of parameters, nested dicts of optimizer state and
batch, a ``GraphBatch`` for a GNN. ``launch/dryrun.py`` resolves the names
onto a mesh and traces ``make_step`` on the tensors.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.optim.adamw import (OptConfig, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     init_opt_state, opt_state_specs)

PAD_MULTIPLE = 8192   # node/edge padding so graph dims divide any mesh


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


def _pad(n: int, mult: int = PAD_MULTIPLE) -> int:
    return -(-n // mult) * mult


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


# model config class -> (module under repro_torch.models, its name stem:
# init_<stem>, <stem>_loss, <stem>_param_specs)
_MODELS = {"LMConfig": ("transformer", "lm"), "GCNConfig": ("gnn.gcn", "gcn"),
           "GINConfig": ("gnn.gin", "gin"), "EGNNConfig": ("gnn.egnn", "egnn"),
           "MACEConfig": ("gnn.mace", "mace"),
           "DIENConfig": ("recsys.dien", "dien")}


def _model(cfg):
    path, stem = _MODELS[type(cfg).__name__]
    mod = importlib.import_module(f"repro_torch.models.{path}")
    return (getattr(mod, f"init_{stem}"), getattr(mod, f"{stem}_loss"),
            getattr(mod, f"{stem}_param_specs"))


def param_builders(arch: Arch, shape: Shape | None = None):
    """Returns (init_fn(generator) -> params, loss_fn(params, batch))."""
    cfg = effective_cfg(arch, shape)
    init, loss, _ = _model(cfg)
    return (lambda g: init(g, cfg)), (lambda p, b: loss(p, b, cfg))


def param_shapes(arch: Arch, shape: Shape | None = None):
    """(params as meta tensors, their logical specs), both flat dicts under
    the parameters' names; nothing is allocated."""
    cfg = effective_cfg(arch, shape)
    init, _, specs_of = _model(cfg)
    params = init(torch.Generator(), cfg, device="meta")
    specs = specs_of(cfg)
    if set(specs) != set(params) or any(
            len(specs[k]) != p.dim() for k, p in params.items()):
        raise ValueError(f"{arch.arch_id}: the logical specs do not match "
                         f"the parameters")
    return params, specs


# ------------------------------------------------------------- input builders


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _lm_inputs(arch: Arch, shape: Shape):
    cfg = arch.model_cfg
    d = shape.dims
    b, s = d["global_batch"], d["seq_len"]
    if shape.kind == "train":
        return ({"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)},
                {"tokens": ("batch", None), "labels": ("batch", None)})
    if shape.kind == "prefill":
        return ({"tokens": _meta((b, s), torch.int32)},
                {"tokens": ("batch", None)})
    if shape.kind == "decode":
        kv = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.d_head)
        kv_spec = (None, "batch", "kv_seq", "kv_heads", None)
        return ({"token": _meta((b, 1), torch.int32),
                 "cache_k": _meta(kv, cfg.cache_dtype),
                 "cache_v": _meta(kv, cfg.cache_dtype),
                 "cache_len": _meta((), torch.int32)},
                {"token": ("batch", None), "cache_k": kv_spec,
                 "cache_v": kv_spec, "cache_len": None})
    raise ValueError(shape.kind)


def _gnn_inputs(arch: Arch, shape: Shape):
    from repro_torch.models.gnn.common import GraphBatch
    d = shape.dims
    n, e = _pad(d["n_nodes"]), _pad(d["n_edges"])
    g = d.get("n_graphs", 1)
    batch = GraphBatch(
        senders=_meta((e,), torch.int32), receivers=_meta((e,), torch.int32),
        edge_mask=_meta((e,), torch.bool),
        feats=_meta((n, d["d_feat"]), torch.float32),
        pos=_meta((n, 3), torch.float32), labels=_meta((n,), torch.int32),
        node_mask=_meta((n,), torch.bool),
        graph_ids=_meta((n,), torch.int32), n_graphs=g)
    specs = GraphBatch(
        senders=("edges",), receivers=("edges",), edge_mask=("edges",),
        feats=("nodes", None), pos=("nodes", None), labels=("nodes",),
        node_mask=("nodes",), graph_ids=("nodes",), n_graphs=g)
    return batch, specs


def _recsys_inputs(arch: Arch, shape: Shape):
    cfg = arch.model_cfg
    d = shape.dims
    b, t, m = d["batch"], cfg.seq_len, cfg.profile_bag
    batch = {"target_item": _meta((b,), torch.int32),
             "target_cat": _meta((b,), torch.int32),
             "hist_items": _meta((b, t), torch.int32),
             "hist_cats": _meta((b, t), torch.int32),
             "hist_mask": _meta((b, t), torch.bool),
             "profile_ids": _meta((b, m), torch.int32),
             "profile_mask": _meta((b, m), torch.bool)}
    specs = {k: ("batch",) + (None,) * (v.dim() - 1)
             for k, v in batch.items()}
    if shape.kind == "train":
        batch["labels"] = _meta((b,), torch.float32)
        batch["neg_items"] = _meta((b, t), torch.int32)
        specs["labels"] = ("batch",)
        specs["neg_items"] = ("batch", None)
    if shape.kind == "retrieval":
        batch["candidate_ids"] = _meta((d["n_candidates"],), torch.int32)
        specs["candidate_ids"] = ("candidates",)
    return batch, specs


def input_specs(arch: Arch, shape: Shape):
    """(the step's batch as meta tensors, its logical specs): the
    reference's names, shapes and dtypes; graph dims padded to
    ``PAD_MULTIPLE``, the decode cache in ``cfg.cache_dtype``."""
    if arch.family in ("lm-dense", "lm-moe"):
        return _lm_inputs(arch, shape)
    if arch.family == "gnn":
        return _gnn_inputs(arch, shape)
    if arch.family == "recsys":
        return _recsys_inputs(arch, shape)
    raise ValueError(arch.family)


def step_arg_specs(arch: Arch, shape: Shape):
    """((args as meta tensors), (their logical specs)), matching
    ``make_step``'s signature: (params, opt_state, batch) for a train step,
    else (params, batch)."""
    batch, batch_specs = input_specs(arch, shape)
    params, p_specs = param_shapes(arch, shape)
    if shape.kind == "train":
        return ((params, init_opt_state(params, arch.opt), batch),
                (p_specs, opt_state_specs(p_specs, arch.opt, params),
                 batch_specs))
    return (params, batch), (p_specs, batch_specs)


def _microbatches(batch: dict, k: int):
    """Microbatch i of a dict batch: rows [i * B / k, (i + 1) * B / k) of
    every tensor (B must divide by k, as the reference's reshape needs)."""
    split = {key: v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
             for key, v in batch.items()}
    return [{key: v[i] for key, v in split.items()} for i in range(k)]


def make_train_step(arch: Arch, loss_fn: Callable,
                    norm_fn: Callable = global_norm,
                    update_fn: Callable = adamw_update) -> Callable:
    """``make_step``'s train step over ``loss_fn(params, batch)``: the
    gradients of the k microbatches (``arch.microbatches``) averaged in
    ``opt.accum_dtype``, clipped by ``norm_fn``'s global norm and applied
    by ``update_fn`` (the sharded step passes its own three)."""
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
        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip,
                                           norm_fn(grads))
        params, opt_state = update_fn(params, grads, opt_state, opt_cfg)
        metrics.update(loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics
    return train_step


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
        return make_train_step(arch, loss_fn)

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
