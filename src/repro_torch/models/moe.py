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

Under the sharded step a rank holds a block of the tokens of a routing
group (``TokenLayout``: a block of its rows, one segment of each). The
routing stays the unsharded one: the per-row expert counts of every rank
are all-gathered, so each assignment's position within its expert, and
with it the capacity drop, is its position in the whole group's order; the
aux losses take the group's counts and this rank's share of the means. The
kept tokens run through the experts on the rank that holds them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.distributed import spmd
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


class TokenLayout(NamedTuple):
    """How the ranks of the ambient mesh split one routing group's tokens
    ([rows, segments of a row, tokens of a segment], row-major): each rank
    holds ``rows`` rows from row ``data_index * rows``, and segment
    ``model_index`` of each when ``seq_split`` (else the whole row, as
    every rank along the model axis does: only its first counts them)."""
    rows: int
    seq_split: bool


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig,
            layout: TokenLayout | None = None):
    """x: [T, d] -> (y: [T, d], aux loss, a float32 scalar). A stream of
    more than ``token_chunk`` tokens that divides into chunks runs chunk by
    chunk (each with its own capacity); its aux loss is the chunks' mean.
    ``layout``: this rank's block of the group under a split mesh."""
    sp = spmd.split()
    if sp is not None and layout is not None:
        return _moe_ffn_split(p, x, cfg, layout, sp)
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

    y = _dispatch_combine(p, x, k, order, slot, keep, top_p, cap)

    # Switch load-balance loss + router z-loss (float32)
    me = probs.mean(dim=0)                                   # mean router prob
    ce = counts.to(torch.float32) / max(t * k, 1)
    balance = cfg.balance_coef * e * torch.sum(me * ce)
    zloss = cfg.router_z_coef * torch.mean(
        torch.logsumexp(logits, dim=-1) ** 2)
    return y, balance + zloss


def _dispatch_combine(p: dict, x: torch.Tensor, k: int, order, slot, keep,
                      top_p, cap: int) -> torch.Tensor:
    """Copy the sorted assignments into their ``slot`` of the [E * cap]
    buffer (the dropped ones to a spare row), run the experts, and sum each
    token's kept outputs weighted by ``top_p``."""
    t, d = x.shape
    e = p["w1"].shape[0]
    dev = x.device
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
    return y


def _moe_ffn_split(p: dict, x: torch.Tensor, cfg: MoEConfig,
                   lay: TokenLayout, sp):
    """``moe_ffn`` over this rank's block of a routing group split over the
    ambient mesh (``TokenLayout``); the group's chunking, capacity, drops
    and aux losses are the unsharded ones."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    dev = x.device
    r = lay.rows
    seg_len = t // r
    n_rows = r * sp.data
    n_seg = sp.model if lay.seq_split else 1
    t_group = n_rows * n_seg * seg_len
    # the group's token chunks, in (row, segment) positions of seg_len
    # tokens each
    t_chunk = t_group
    if t_group > cfg.token_chunk and t_group % cfg.token_chunk == 0:
        t_chunk = cfg.token_chunk
    if t_chunk % seg_len:
        raise NotImplementedError(f"token chunks of {t_chunk} across "
                                  f"segments of {seg_len} tokens")
    chunk_pos = t_chunk // seg_len
    n_chunks = t_group // t_chunk
    cap = moe_capacity(t_chunk, cfg)

    logits, probs, top_p, top_e = _route(p, x, k)
    top_e, by_e = torch.sort(top_e, dim=-1)
    top_p = torch.gather(top_p, -1, by_e)
    flat_e = top_e.reshape(-1)                               # [t*k]
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    row_of = torch.arange(t * k, device=dev) // (seg_len * k)
    rc = torch.zeros(r * e, dtype=torch.int64, device=dev).index_add_(
        0, row_of * e + flat_e, torch.ones_like(flat_e)).view(r, e)

    # every rank's row counts at their (row, segment) in the group's order;
    # a copy of another rank's tokens adds none
    ranks = torch.arange(sp.n, device=dev)
    di, mi = ranks // sp.model, ranks % sp.model
    seg = mi if lay.seq_split else torch.zeros_like(mi)
    owner = lay.seq_split | (mi == 0)
    at = ((di[:, None] * r + torch.arange(r, device=dev)) * n_seg
          + seg[:, None]).reshape(-1)                        # [N * r]
    allc = spmd.gather_all(rc) * owner.repeat_interleave(r)[:, None]
    table = torch.zeros((n_rows * n_seg, e), dtype=torch.int64,
                        device=dev).index_add_(0, at, allc)
    before = torch.cumsum(table, 0) - table
    chunk = torch.arange(n_rows * n_seg, device=dev) // chunk_pos
    before = before - before[chunk * chunk_pos]      # within the chunk
    my_seg = sp.model_index if lay.seq_split else 0
    mine = (sp.data_index * r + torch.arange(r, device=dev)) * n_seg + my_seg
    off = before[mine]                                # [r, E]

    counts = rc.sum(0)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - starts[se]
    row_s = row_of[order]
    local_before = torch.cumsum(rc, 0) - rc
    pos = off[row_s, se] + pos_in_e - local_before[row_s, se]
    keep = pos < cap
    ch_of_row = mine // chunk_pos
    first, last = ((sp.data_index * r + i) * n_seg + my_seg
                   for i in (0, r - 1))
    one_chunk = first // chunk_pos == last // chunk_pos
    c_loc = min(cap, t) if one_chunk else t
    slot = torch.where(keep, se * c_loc + pos_in_e, e * c_loc)
    y = _dispatch_combine(p, x, k, order, slot, keep, top_p, c_loc)

    # aux losses: each chunk's, from its counts, averaged over the chunks;
    # this rank's share of the sums over its tokens
    chunk_counts = torch.zeros((n_chunks, e), dtype=torch.int64,
                               device=dev).index_add_(0, chunk, table)
    ce = chunk_counts.to(torch.float32) / max(t_chunk * k, 1)
    me_rows = probs.view(r, seg_len, e).sum(1)                # [r, E]
    z_rows = (torch.logsumexp(logits, dim=-1) ** 2).view(r, seg_len).sum(1)
    balance = cfg.balance_coef * e * torch.sum(me_rows * ce[ch_of_row])
    zloss = cfg.router_z_coef * torch.sum(z_rows)
    mine_counts = owner[sp.rank].to(torch.float32)
    return y, (balance + zloss) * mine_counts / (t_chunk * n_chunks)


def moe_ffn_dense_ref(p: dict, x: torch.Tensor, cfg: MoEConfig):
    """O(T * E) dense version, no capacity drops (for tests): every expert
    on every token, weighted by the renormalised top-k probabilities."""
    _, probs, top_p, top_e = _route(p, x, cfg.top_k)
    h = torch.einsum("td,edf->tef", x, p["w1"])
    g = torch.einsum("td,edf->tef", x, p["w3"])
    o = torch.einsum("tef,efd->ted", F.silu(h) * g, p["w2"])  # [T, E, d]
    w = torch.zeros_like(probs).scatter(-1, top_e, top_p)
    return torch.einsum("te,ted->td", w.to(x.dtype), o)
