"""AdamW over a flat dict of parameter tensors, and its factored variant
(port of ``repro/optim/adamw.py``).

Plain functions, no ``torch.optim``: the update repeats the reference's
float32 arithmetic step by step (``bc1 = 1 - b1**t`` with ``t`` a float32
tensor, ``denom = sqrt(v / bc2) + eps``, ``upd = m_hat / denom + wd * p``),
which ``torch.optim.AdamW`` does not (it decays the weights apart and adds
``eps`` elsewhere). ``b1 = 0`` keeps no first moment. ``factored=True``
replaces the full second moment of every tensor whose two trailing
dimensions are both at least 2 with row and column statistics over those
two dimensions (Adafactor-style ``vr`` [..., rows] and ``vc`` [...,
cols]); the stacked ``[n_layers, d]`` norm scales of an LM count as such a
tensor, as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    factored: bool = False
    # microbatch gradient-accumulation dtype (``configs.base.make_step``)
    accum_dtype: str = "float32"

    @property
    def mdt(self) -> torch.dtype:
        return getattr(torch, self.moment_dtype)


def _is_factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def init_opt_state(params: dict[str, torch.Tensor], cfg: OptConfig) -> dict:
    """{"step": int32 scalar, "per_param": {name: {"m", "v"}}} ("m" only
    with b1 > 0; "vr", "vc" in place of "v" for a factored tensor), zeros
    on each parameter's device."""

    def one(p):
        st = {}
        if cfg.b1 > 0:
            st["m"] = torch.zeros_like(p, dtype=cfg.mdt)
        if cfg.factored and _is_factorable(p.shape):
            st["vr"] = torch.zeros(p.shape[:-1], dtype=cfg.mdt,
                                   device=p.device)
            st["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:],
                                   dtype=cfg.mdt, device=p.device)
        else:
            st["v"] = torch.zeros_like(p, dtype=cfg.mdt)
        return st

    device = next(iter(params.values())).device if params else None
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "per_param": {k: one(p) for k, p in params.items()}}


def opt_state_specs(param_specs: dict, cfg: OptConfig,
                    params: dict) -> dict:
    """Logical specs mirroring ``init_opt_state``'s structure: a moment
    takes its parameter's spec, a factored row statistic drops the last
    axis and a column statistic the one before it; "step" is None."""

    def one(spec, shape):
        spec = tuple(spec) if spec is not None else (None,) * len(shape)
        st = {}
        if cfg.b1 > 0:
            st["m"] = spec
        if cfg.factored and _is_factorable(shape):
            st["vr"] = spec[:-1]
            st["vc"] = spec[:-2] + spec[-1:]
        else:
            st["v"] = spec
        return st

    return {"step": None,
            "per_param": {k: one(param_specs[k], p.shape)
                          for k, p in params.items()}}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float,
                        norm: torch.Tensor | None = None):
    """(grads scaled to at most ``max_norm`` in global norm, the norm);
    ``norm`` passes the norm when the caller has it."""
    norm = global_norm(grads) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale.to(g.dtype) for k, g in grads.items()}, norm


def _mean(x: torch.Tensor, dim: int, param_dim: int, name: str):
    return x.mean(dim=dim)


@torch.no_grad()
def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict,
                 cfg: OptConfig, mean=_mean):
    """Returns (new_params, new_state); the inputs are left as they are.
    Handles both the full and the factored second moment. ``mean(x, dim,
    param_dim, name)`` takes the factored statistics' means over ``dim`` of
    ``x``, which is parameter ``name``'s dimension ``param_dim`` (the
    sharded step reduces it over the ranks that split it)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    new_params, new_per = {}, {}
    for name, p in params.items():
        g32 = grads[name].to(torch.float32)
        st = state["per_param"][name]
        new_st = {}
        if cfg.b1 > 0:
            m = st["m"].to(torch.float32) * cfg.b1 + g32 * (1 - cfg.b1)
            new_st["m"] = m.to(cfg.mdt)
            m_hat = m / bc1
        else:
            m_hat = g32
        if "v" in st:
            v = st["v"].to(torch.float32) * cfg.b2 + g32 * g32 * (1 - cfg.b2)
            new_st["v"] = v.to(cfg.mdt)
            denom = torch.sqrt(v / bc2) + cfg.eps
        else:
            g2 = g32 * g32
            vr = st["vr"].to(torch.float32) * cfg.b2 \
                + mean(g2, -1, -1, name) * (1 - cfg.b2)
            vc = st["vc"].to(torch.float32) * cfg.b2 \
                + mean(g2, -2, -2, name) * (1 - cfg.b2)
            new_st["vr"], new_st["vc"] = vr.to(cfg.mdt), vc.to(cfg.mdt)
            vr_hat, vc_hat = vr / bc2, vc / bc2
            v_est = (vr_hat[..., None] * vc_hat[..., None, :]
                     / torch.clamp(mean(vr_hat, -1, -2, name)[..., None,
                                                               None],
                                   min=1e-30))
            denom = torch.sqrt(v_est) + cfg.eps
        upd = m_hat / denom + cfg.weight_decay * p.to(torch.float32)
        new_params[name] = (p.to(torch.float32) - cfg.lr * upd).to(p.dtype)
        new_per[name] = new_st
    return new_params, {"step": step, "per_param": new_per}
