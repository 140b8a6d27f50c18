"""Mixture-of-Experts FFN (port of ``repro/models/moe.py``): top-k routing
with sort-based capacity dispatch.

  1. router: softmax over experts in float32, top-k per token, the k
     probabilities renormalised;
  2. the (token, k) assignments flattened and stably sorted by expert id;
  3. each assignment's position within its expert from the sorted offsets;
     past the per-expert capacity it is dropped (GShard capacity
     semantics: a dropped assignment adds nothing);
  4. the kept tokens copied into an [E, C, d] buffer, all experts run as
     one batched product, each token's k outputs weighted and summed.

Every reduction runs in a fixed order, so a step repeats bit for bit on
the card too (no float atomics). The dispatch writes each kept slot once
(the reference's scatter-add into the buffer adds to each kept slot once;
its dropped assignments add zeros to slot 0, which here go to a spare row
that is then cut off). The combine does not scatter-add: each token's k
contributions are summed one after the other in ascending expert id, the
order in which the reference's scatter applies them (they arrive sorted by
expert). Gathers whose backward scatters do so to distinct rows (a
permutation) or to the spare row alone.

Aux losses (float32): the Switch load-balance loss and the router z-loss.
Parameters of one layer: ``router`` [d, E] (always float32), ``w1``,
``w3`` [E, d, f] and ``w2`` [E, f, d].
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.models.layers import _dense_init


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_z_coef: float = 1e-3
    balance_coef: float = 1e-2
    # dispatch token chunk: the [E, C, d] buffer exists per chunk of this
    # many tokens, not per step
    token_chunk: int = 16384


def moe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32, device=None) -> dict:
    """As the reference's: each weight normal over the square root of its
    first dimension (the expert count for w1, w3 and w2)."""
    e, f = cfg.num_experts, cfg.d_ff_expert
    return {"router": _dense_init(gen, (d_model, e), torch.float32,
                                  device=device),
            "w1": _dense_init(gen, (e, d_model, f), dtype, device=device),
            "w3": _dense_init(gen, (e, d_model, f), dtype, device=device),
            "w2": _dense_init(gen, (e, f, d_model), dtype, device=device)}


def moe_specs() -> dict:
    return {"router": ("embed", None), "w1": ("experts", "embed", "mlp"),
            "w3": ("experts", "embed", "mlp"),
            "w2": ("experts", "mlp", "embed")}


def moe_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    cap = int(np.ceil(n_tokens * cfg.top_k / cfg.num_experts
                      * cfg.capacity_factor))
    return max(8, -(-cap // 8) * 8)   # rounded up to a multiple of 8


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """x: [T, d] -> (y: [T, d], aux loss, a float32 scalar). A stream of
    more than ``token_chunk`` tokens that divides into chunks runs chunk by
    chunk (each with its own capacity); its aux loss is the chunks' mean."""
    t, d = x.shape
    if t > cfg.token_chunk and t % cfg.token_chunk == 0:
        ys, auxs = zip(*(_moe_ffn_chunk(p, xc, cfg)
                         for xc in x.split(cfg.token_chunk)))
        return torch.cat(ys), torch.stack(auxs).mean()
    return _moe_ffn_chunk(p, x, cfg)


def _route(p: dict, x: torch.Tensor, k: int):
    logits = x.to(torch.float32) @ p["router"]             # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)            # [T, k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_p, top_e


def _moe_ffn_chunk(p: dict, x: torch.Tensor, cfg: MoEConfig):
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = moe_capacity(t, cfg)
    dev = x.device

    logits, probs, top_p, top_e = _route(p, x, k)
    # each token's k assignments in ascending expert id: the order of the
    # combine's sum (the stable sort below does not depend on it, since a
    # token's k experts differ)
    top_e, by_e = torch.sort(top_e, dim=-1)
    top_p = torch.gather(top_p, -1, by_e)

    flat_e = top_e.reshape(-1)                               # [T*k]
    order = torch.argsort(flat_e, stable=True)               # by expert
    se = flat_e[order]
    # [E]; an index_add, not bincount: its length is known without the
    # data, so the dry-run traces it on meta tensors
    counts = torch.zeros(e, dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[se]
    keep = pos_in_e < cap
    # the slot of each sorted assignment in the flat [E * C] buffer; the
    # dropped ones all go to a spare row E * C
    slot = torch.where(keep, se * cap + pos_in_e, e * cap)

    # the token rows in sorted order: each token k times (its expand sums
    # back in the backward), then a permutation
    xs = x[:, None, :].expand(t, k, d).reshape(t * k, d)[order]
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf = buf.index_put((slot,), xs)[:e * cap].view(e, cap, d)

    h = torch.bmm(buf, p["w1"])
    g = torch.bmm(buf, p["w3"])
    out_buf = torch.bmm(F.silu(h) * g, p["w2"])              # [E, C, d]

    out_flat = torch.cat([out_buf.reshape(e * cap, d),
                          torch.zeros((1, d), dtype=x.dtype, device=dev)])
    # back from sorted to token order (a permutation), then weighted
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    kept = keep[inv].view(t, k)
    rows = out_flat[slot[inv]].view(t, k, d)
    weight = torch.where(kept, top_p, 0.0).to(x.dtype)
    contrib = rows * weight[..., None]
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]

    # Switch load-balance loss + router z-loss (float32)
    me = probs.mean(dim=0)                                   # mean router prob
    ce = counts.to(torch.float32) / max(t * k, 1)
    balance = cfg.balance_coef * e * torch.sum(me * ce)
    zloss = cfg.router_z_coef * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    return y, balance + zloss


def moe_ffn_dense_ref(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """O(T * E) dense version, no capacity drops (for tests): every expert
    on every token, weighted by the renormalised top-k probabilities."""
    _, probs, top_p, top_e = _route(p, x, cfg.top_k)
    h = torch.einsum("td,edf->tef", x, p["w1"])
    g = torch.einsum("td,edf->tef", x, p["w3"])
    o = torch.einsum("tef,efd->ted", F.silu(h) * g, p["w2"])  # [T, E, d]
    w = torch.zeros_like(probs).scatter(-1, top_e, top_p)
    return torch.einsum("te,ted->td", w.to(x.dtype), o)
