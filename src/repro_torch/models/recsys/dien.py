"""DIEN (Zhou et al., arXiv:1809.03672), port of
``repro/models/recsys/dien.py``: the Deep Interest Evolution Network.

Pipeline: sparse id features -> embedding lookup (gather + masked reduce)
-> interest extraction GRU over the behaviour sequence -> attention vs
target -> interest evolution AUGRU (attention scales the update gate) ->
concat features -> MLP(200, 80) -> logit.

Aux loss (paper §4.2): next-behaviour discrimination on GRU hidden states
against the batch's negatives.

Serving heads:
  * ``dien_forward``      CTR logit (serve_p99 / serve_bulk shapes);
  * ``dien_retrieval``    user vector vs N candidate item embeddings as one
    matmul + top-k (retrieval_cand shape; never a loop).

The two scans are Python loops over the sequence. Parameters are a flat
dict named as the reference's tree: ``item_table``, ``cat_table``,
``profile_table``, ``gru.{wx,wh,b}``, ``augru.{wx,wh,b}``, ``att.{j}.w`` /
``.b``, ``mlp.{j}.w`` / ``.b`` and ``user_proj.w``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.distributed import spmd
from repro_torch.models import layers as L
from repro_torch.models.params import flatten, prefixed, unflatten


@dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: tuple = (200, 80)
    n_items: int = 1_000_000
    n_cats: int = 1_000
    n_profiles: int = 100_000
    profile_bag: int = 8          # multi-hot profile ids per user
    use_aux_loss: bool = True
    dtype: str = "float32"

    @property
    def behav_dim(self) -> int:
        return 2 * self.embed_dim  # item ++ category


def _normal(gen, shape, scale, device):
    return torch.randn(shape, generator=gen, device=device) * scale


def _gru_init(gen, d_in, d_h, device):
    s = float(1.0 / np.sqrt(np.float32(d_in + d_h)))
    return {"wx": _normal(gen, (d_in, 3 * d_h), s, device),
            "wh": _normal(gen, (d_h, 3 * d_h), s, device),
            "b": torch.zeros((3 * d_h,), device=device)}


def _gru_cell(p, h, x, att=None):
    gx = x @ p["wx"] + p["b"]
    gh = h @ p["wh"]
    xz, xr, xn = torch.chunk(gx, 3, -1)
    hz, hr, hn = torch.chunk(gh, 3, -1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    n = torch.tanh(xn + r * hn)
    if att is not None:                 # AUGRU: attention scales update gate
        z = z * att[:, None]
    return (1.0 - z) * h + z * n


def init_dien(gen: torch.Generator, cfg: DIENConfig, device=None) -> dict:
    device = gen.device if device is None else device
    e = cfg.embed_dim
    tree = {
        "item_table": _normal(gen, (cfg.n_items, e), 0.05, device),
        "cat_table": _normal(gen, (cfg.n_cats, e), 0.05, device),
        "profile_table": _normal(gen, (cfg.n_profiles, e), 0.05, device),
        "gru": _gru_init(gen, cfg.behav_dim, cfg.gru_dim, device),
        "augru": _gru_init(gen, cfg.behav_dim, cfg.gru_dim, device),
        "att": L.mlp_init(gen, [cfg.gru_dim + cfg.behav_dim, 36, 1],
                          device=device),
        "mlp": L.mlp_init(gen, [cfg.gru_dim + 2 * cfg.behav_dim + e,
                                *cfg.mlp_dims, 1], device=device),
        "user_proj": L.dense(gen, cfg.gru_dim, e, device=device),
    }
    return flatten(tree)


def dien_param_specs(cfg: DIENConfig) -> dict:
    """The reference's own table: the tables shard their rows as a vocab
    (the category table stays whole), the MLP its hidden widths."""
    gru = {"wx": (None, "mlp"), "wh": (None, "mlp"), "b": ("mlp",)}
    n_mlp = len(cfg.mlp_dims) + 1
    mlp = {}
    for j in range(n_mlp):
        w = ((None if j == 0 else "mlp"), (None if j == n_mlp - 1 else "mlp"))
        mlp.update({f"{j}.w": w, f"{j}.b": (w[1],)})
    return {"item_table": ("vocab", "embed"), "cat_table": (None, "embed"),
            "profile_table": ("vocab", "embed"),
            **prefixed("gru", gru), **prefixed("augru", gru),
            "att.0.w": (None, None), "att.0.b": (None,),
            "att.1.w": (None, None), "att.1.b": (None,),
            **prefixed("mlp", mlp), "user_proj.w": (None, "embed")}


def embedding_bag(table, ids, mask, op: str = "mean"):
    """ids int[B, M], mask bool[B, M] -> [B, e]: gather + masked reduce."""
    rows = table[ids.long()]                            # [B, M, e]
    rows = torch.where(mask[..., None], rows, 0.0)
    s = rows.sum(dim=1)
    if op == "sum":
        return s
    return s / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)


def _behaviour_embed(p, items, cats):
    return torch.cat([p["item_table"][items.long()],
                      p["cat_table"][cats.long()]], dim=-1)


def _interest_states(p, behav, mask, cfg: DIENConfig):
    """GRU over time: behav [B, T, 2e] -> states [B, T, H]."""
    h = behav.new_zeros((behav.shape[0], cfg.gru_dim))
    states = []
    for t in range(behav.shape[1]):
        h2 = _gru_cell(p["gru"], h, behav[:, t])
        h = torch.where(mask[:, t, None], h2, h)
        states.append(h)
    return torch.stack(states, dim=1)                   # [B, T, H]


def _evolution(p, states, behav, target, mask, cfg: DIENConfig):
    """Attention vs target + AUGRU roll. Returns final interest [B, H]."""
    b, t, _ = states.shape
    tgt = target[:, None, :].expand(b, t, target.shape[-1])
    att_in = torch.cat([states, tgt], dim=-1)
    scores = L.apply_mlp(p["att"], att_in, act="sigmoid")[..., 0]
    scores = torch.where(mask, scores, -1e30)
    att = torch.softmax(scores, dim=1)                  # [B, T]
    h = states.new_zeros((b, cfg.gru_dim))
    for i in range(t):
        h2 = _gru_cell(p["augru"], h, behav[:, i], att=att[:, i])
        h = torch.where(mask[:, i, None], h2, h)
    return h


def _user_state(p, batch, cfg: DIENConfig):
    behav = _behaviour_embed(p, batch["hist_items"], batch["hist_cats"])
    mask = batch["hist_mask"]
    states = _interest_states(p, behav, mask, cfg)
    target = _behaviour_embed(p, batch["target_item"], batch["target_cat"])
    hT = _evolution(p, states, behav, target, mask, cfg)
    pooled = torch.where(mask[..., None], behav, 0.0).sum(1) / torch.clamp(
        mask.sum(1, keepdim=True), min=1.0)
    profile = embedding_bag(p["profile_table"], batch["profile_ids"],
                            batch["profile_mask"])
    feats = torch.cat([hT, target, pooled, profile], dim=-1)
    return hT, states, behav, feats


def dien_user_state(params: dict, batch, cfg: DIENConfig):
    """Shared trunk -> (final interest [B, H], states [B, T, H], behaviour
    embeddings [B, T, 2e], feature vector [B, F])."""
    return _user_state(unflatten(params), batch, cfg)


def dien_forward(params: dict, batch, cfg: DIENConfig) -> torch.Tensor:
    """CTR logit [B]."""
    p = unflatten(params)
    _, _, _, feats = _user_state(p, batch, cfg)
    return L.apply_mlp(p["mlp"], feats, act="relu")[:, 0]


def _aux_loss(p, states, batch, cfg: DIENConfig):
    """Next-behaviour discrimination: sigma(h_t . e_{t+1}) vs negatives."""
    pos = _behaviour_embed(p, batch["hist_items"], batch["hist_cats"])
    neg = _behaviour_embed(p, batch["neg_items"], batch["hist_cats"])
    h = states[:, :-1]                                   # [B, T-1, H]
    proj = L.apply_dense(p["user_proj"], h)              # [B, T-1, e]
    # score against the item part of the next behaviour embedding
    pos_it = pos[:, 1:, :cfg.embed_dim]
    neg_it = neg[:, 1:, :cfg.embed_dim]
    m = batch["hist_mask"][:, 1:].to(torch.float32)
    lp = F.logsigmoid(torch.sum(proj * pos_it, -1))
    ln = F.logsigmoid(-torch.sum(proj * neg_it, -1))
    return -spmd.split_mean(lp + ln, m)


def dien_loss(params: dict, batch, cfg: DIENConfig):
    p = unflatten(params)
    hT, states, behav, feats = _user_state(p, batch, cfg)
    logit = L.apply_mlp(p["mlp"], feats, act="relu")[:, 0]
    y = batch["labels"].to(torch.float32)
    bce = -spmd.split_mean(y * F.logsigmoid(logit)
                           + (1 - y) * F.logsigmoid(-logit))
    if cfg.use_aux_loss and "neg_items" in batch:
        aux = _aux_loss(p, states, batch, cfg)
    else:
        aux = torch.zeros((), device=bce.device)
    return bce + 0.5 * aux, {"bce": bce, "aux": aux}


def dien_retrieval(params: dict, batch, cfg: DIENConfig, top_k: int = 100):
    """Score one or a few users against the candidate items, one matmul.

    batch["candidate_ids"] int[Nc]: rows of the item table to score.
    Returns (scores [B, Nc], top-k ids [B, k], best first)."""
    p = unflatten(params)
    hT, _, _, _ = _user_state(p, batch, cfg)
    user_vec = L.apply_dense(p["user_proj"], hT)         # [B, e]
    ids = batch["candidate_ids"]
    cand = p["item_table"][ids.long()]                   # [Nc, e]
    scores = user_vec @ cand.T                           # [B, Nc]
    if spmd.split() is None:
        _, top = torch.topk(scores, top_k, dim=-1, sorted=True)
        return scores, top
    # a block of the candidates a rank: its own best, then the best of
    # every rank's (scores: this rank's block)
    val, at = torch.topk(scores, min(top_k, scores.shape[1]), dim=-1,
                         sorted=True)
    val = spmd.gather_all(val.transpose(0, 1).contiguous())   # [N*k, B]
    cid = spmd.gather_all(ids.long()[at].transpose(0, 1).contiguous())
    _, best = torch.topk(val.transpose(0, 1), top_k, dim=-1, sorted=True)
    return scores, torch.gather(cid.transpose(0, 1), 1, best).to(ids.dtype)
