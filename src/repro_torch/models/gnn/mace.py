"""MACE (Batatia et al., arXiv:2206.07697), port of
``repro/models/gnn/mace.py``: higher-order equivariant message passing.

Per layer t (node irrep features H[N, C, 9], components ordered l=0,1,2):

  A_i[c, o]  = Σ_{j∈N(i)}  R[e, c] · Σ_{a,b} H_j[c, a] Y_b(r̂_ij) G[a, b, o]
  B2_i[c, o] = Σ_{a,b} A_i[c,a]  A_i[c,b] G[a,b,o]        (correlation 2)
  B3_i[c, o] = Σ_{a,b} B2_i[c,a] A_i[c,b] G[a,b,o]        (correlation 3)
  H'_i[:, o] = Σ_l 1[o∈l] ( W1_l A + W2_l B2 + W3_l B3 )[·, o]  + residual

R[e, c] are per-channel radial weights from an MLP over n_rbf Bessel basis
functions with a polynomial cutoff envelope; G is the Gaunt coupling
(``sph.gaunt_tensor``), so every operation is exactly E(3)-equivariant and
the readout uses only the l=0 components (invariant site energies).

The three-operand contractions are taken two operands at a time, so no
[E, C, 9, 9] intermediate is built: the message contracts Y with G first
(``eb,abo->eao``, [E, 9, 9]) and then takes one batched product over ``a``
per edge; B2 and B3 contract the left factor with G ([N, C, 9, 9]) and then
sum over ``b`` per node and channel. The sums are the
reference's in another order. ``cfg.remat`` recomputes each interaction
layer in the backward (``torch.utils.checkpoint``). The aggregation runs
through ``distributed/aggregate.py::owner_gather_scatter`` and A and H are
``constrain``ed to the node sharding, as the reference's. Parameters are a flat
dict named as the reference's tree: ``embed.w`` / ``.b``,
``layers.{t}.radial.{j}.w`` / ``.b``, ``layers.{t}.w1`` / ``w2`` / ``w3``
[3, C, C] and ``readout.{j}.w`` / ``.b``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import spmd
from repro_torch.distributed.aggregate import owner_gather_scatter
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.gnn.common import (GraphBatch, global_nodes,
                                           graph_pool, graph_targets)
from repro_torch.models.gnn.sph import LS, N_COMP, gaunt_tensor, real_sph
from repro_torch.models.params import flatten, prefixed, unflatten


@dataclass(frozen=True)
class MACEConfig:
    name: str = "mace"
    n_layers: int = 2
    d_hidden: int = 128          # channels
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    r_cut: float = 5.0
    d_feat: int = 64             # input node feature dim
    dtype: str = "float32"       # message and feature dtype
    remat: bool = False          # checkpoint each interaction layer


def bessel_basis(r: torch.Tensor, n_rbf: int, r_cut: float) -> torch.Tensor:
    """e(n) = sqrt(2/rc) sin(n pi r / rc) / r with smooth polynomial cutoff."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    basis = np.float32(np.sqrt(2.0 / r_cut)) * torch.sin(
        n[None, :] * np.pi * r[:, None] / r_cut) / r[:, None]
    t = torch.clamp(r / r_cut, 0.0, 1.0)
    env = 1.0 - 10.0 * t ** 3 + 15.0 * t ** 4 - 6.0 * t ** 5
    return basis * env[:, None]


def init_mace(gen: torch.Generator, cfg: MACEConfig, device=None) -> dict:
    c = cfg.d_hidden
    tree = {"embed": L.dense(gen, cfg.d_feat, c, bias=True, device=device),
            "readout": L.mlp_init(gen, [c, c, 1], device=device),
            "layers": []}
    f32 = torch.float32
    for _ in range(cfg.n_layers):
        tree["layers"].append({
            # radial MLP: n_rbf -> c (per-channel radial weight)
            "radial": L.mlp_init(gen, [cfg.n_rbf, c, c], device=device),
            # per-l channel mixing for each correlation order
            "w1": L._dense_init(gen, (3, c, c), f32, device=device),
            "w2": L._dense_init(gen, (3, c, c), f32, scale=0.1 / np.sqrt(c),
                                device=device),
            "w3": L._dense_init(gen, (3, c, c), f32,
                                scale=0.01 / np.sqrt(c), device=device)})
    return flatten(tree)


def mace_param_specs(cfg: MACEConfig) -> dict:
    """The reference's own table (not ``mlp_specs``'): the radial MLP's
    input and the readout carry no logical axis."""
    specs = {**prefixed("embed", L.dense_specs(("embed", "mlp"), bias=True)),
             "readout.0.w": (None, None), "readout.0.b": (None,),
             "readout.1.w": (None, None), "readout.1.b": (None,)}
    for t in range(cfg.n_layers):
        specs.update({
            f"layers.{t}.radial.0.w": (None, "mlp"),
            f"layers.{t}.radial.0.b": ("mlp",),
            f"layers.{t}.radial.1.w": ("mlp", "mlp"),
            f"layers.{t}.radial.1.b": ("mlp",),
            **{f"layers.{t}.{w}": (None, "mlp", "mlp")
               for w in ("w1", "w2", "w3")}})
    return specs


def _per_l_mix(w_l: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """feats [N, C, 9], w_l [3, C, C]: channel mixing within each l block."""
    w_per_comp = w_l[torch.as_tensor(LS, device=w_l.device)]   # [9, C, C]
    return torch.einsum("nco,odc->ndo", feats, w_per_comp)


def _couple(x: torch.Tensor, a: torch.Tensor, g: torch.Tensor):
    """out[n, c, o] = Σ_{a,b} x[n,c,a] a[n,c,b] G[a,b,o]: x with G as one
    matmul ([N, C, 9, 9]), then the sum over b as a product and a
    reduction. (A batched matmul of N·C products of [1, 9] by [9, 9] runs
    as tiny batched GEMMs, several times slower on the card.)"""
    n, c, k = x.shape
    xg = (x.reshape(n * c, k) @ g.reshape(k, k * k)).reshape(n, c, k, k)
    return (a[..., None] * xg).sum(dim=-2)


def _message(hj: torch.Tensor, edge_data) -> torch.Tensor:
    """The message tensor product (H_j ⊗ Y)_o through the Gaunt coupling,
    weighted by the radial channels: [E, C, 9]."""
    yg, radial = edge_data
    return torch.bmm(hj, yg) * radial[:, :, None]


def mace_forward(params: dict, gb: GraphBatch, cfg: MACEConfig):
    """Returns (H [N, C, 9], energy [G])."""
    p = unflatten(params)
    adt = getattr(torch, cfg.dtype)
    dev = gb.feats.device
    g = torch.from_numpy(gaunt_tensor()).to(dev, adt)           # [9, 9, 9]
    n_loc, n, c = gb.n_nodes, global_nodes(gb), cfg.d_hidden
    snd, rcv = gb.senders.long(), gb.receivers.long()

    h0 = F.silu(gb.feats @ p["embed"]["w"] + p["embed"]["b"])
    H = torch.cat([h0.to(adt)[:, :, None],
                   h0.new_zeros((n_loc, c, N_COMP - 1), dtype=adt)], dim=2)

    pos = spmd.gather_nodes(gb.pos)      # both ends of the rank's edges
    rel = pos[rcv] - pos[snd]
    r = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-18)
    rbf = bessel_basis(r, cfg.n_rbf, cfg.r_cut)                # [E, n_rbf]
    y = real_sph(rel / torch.clamp(r, min=1e-6)[:, None])       # [E, 9]
    # Degenerate edges (self-loops / padding, r ~ 0) have no direction:
    # Y(0) is not a valid l>0 object (Y20(0) = -c != 0 would inject a
    # non-rotating pseudo-vector and silently break equivariance), so they
    # carry only their scalar (l=0) component.
    l0_only = torch.tensor([1.0] + [0.0] * (N_COMP - 1), dtype=y.dtype,
                           device=dev)
    y = torch.where((r > 1e-6)[:, None], y, y * l0_only)
    y = torch.where(gb.edge_mask[:, None], y, 0.0).to(adt)
    yg = torch.einsum("eb,abo->eao", y, g)                     # [E, 9, 9]

    def layer(H, lp):
        radial = L.apply_mlp(lp["radial"], rbf, act="silu").to(adt)
        # owner-aligned exchange: one all-gather of H forward and one
        # reduce-scatter, and their transposes backward
        A = owner_gather_scatter(H, gb.senders, gb.receivers, (yg, radial),
                                 _message, n)
        A = constrain(A, ("nodes", None, None))
        # higher-order (symmetric) products: correlation 2 and 3
        B2 = _couple(A, A, g)
        B3 = _couple(B2, A, g)
        upd = (_per_l_mix(lp["w1"].to(adt), A)
               + _per_l_mix(lp["w2"].to(adt), B2)
               + _per_l_mix(lp["w3"].to(adt), B3))
        return constrain(H + upd, ("nodes", None, None))

    for lp in p["layers"]:
        if cfg.remat:
            H = checkpoint(layer, H, lp, use_reentrant=False)
        else:
            H = layer(H, lp)

    site_e = L.apply_mlp(p["readout"], H[:, :, 0].to(torch.float32),
                         act="silu")[:, 0]
    return H, graph_pool(site_e, gb)


def mace_loss(params: dict, gb: GraphBatch, cfg: MACEConfig):
    _, energy = mace_forward(params, gb, cfg)
    target = graph_targets(gb).to(torch.float32)
    loss = spmd.split_mean((energy - target) ** 2)
    return loss, {"mse": loss}
