"""Analytic FLOP estimates per (arch x shape), the napkin-math layer (port
of ``repro/launch/flops.py``; the formulas are the reference's, kept here
as the port's own copy).

Two numbers per cell:
  model_flops    — useful work: 6*N_active*D for LM training (2*N*D per
                   forward), causal attention at half the score matrix,
                   analytic per-op counts for GNN/recsys;
  executed_flops — what the compiled program actually has to run: full
                   (masked) score matrices, remat recompute (fwd twice),
                   MoE capacity slack.

The dry-run's compute term uses executed_flops per device; the counting
mode of ``launch/roofline.py`` traces the step itself beside it
(``counted_flops_global``).
"""
from __future__ import annotations

from repro_torch.configs.base import Arch, Shape


def _lm_flops(arch: Arch, shape: Shape) -> dict:
    cfg = arch.model_cfg
    d = shape.dims
    n_act = cfg.active_param_count()
    L, Hq, Dh = cfg.n_layers, cfg.n_heads, cfg.d_head
    if shape.kind == "train":
        b, s = d["global_batch"], d["seq_len"]
        tokens = b * s
        attn_fwd_full = 4 * L * b * s * s * Hq * Dh       # QK^T + PV
        model = 6 * n_act * tokens + 3 * (attn_fwd_full / 2)   # causal half
        executed = 8 * n_act * tokens + 4 * attn_fwd_full      # remat fwd x2
        if cfg.moe is not None:
            cap_slack = cfg.moe.capacity_factor
            ffn_act = cfg.moe.top_k * 3 * cfg.d_model * cfg.moe.d_ff_expert * L
            executed += (cap_slack - 1.0) * 8 * ffn_act * tokens / 2
        return dict(model_flops=model, executed_flops=executed)
    if shape.kind == "prefill":
        b, s = d["global_batch"], d["seq_len"]
        tokens = b * s
        attn_fwd_full = 4 * L * b * s * s * Hq * Dh
        return dict(model_flops=2 * n_act * tokens + attn_fwd_full / 2,
                    executed_flops=2 * n_act * tokens + attn_fwd_full)
    # decode: one token against an s-deep cache
    b, s = d["global_batch"], d["seq_len"]
    attn = 4 * L * b * s * Hq * Dh
    return dict(model_flops=2 * n_act * b + attn,
                executed_flops=2 * n_act * b + attn)


def _gnn_flops(arch: Arch, shape: Shape) -> dict:
    cfg = arch.model_cfg
    d = shape.dims
    n, e = d["n_nodes"], d["n_edges"]
    name = type(cfg).__name__
    h = cfg.d_hidden
    if name == "GCNConfig":
        f = d["d_feat"]
        fwd = 2 * n * f * h + 2 * n * h * d.get("n_classes", 16) + 4 * e * h
    elif name == "GINConfig":
        f = d["d_feat"]
        fwd = cfg.n_layers * (2 * n * h * h * 2 + 2 * e * h) + 2 * n * f * h
    elif name == "EGNNConfig":
        fwd = cfg.n_layers * (e * (2 * (2 * h + 1) * h + 2 * h * h * 2)
                              + n * (2 * 2 * h * h + 2 * h * h))
    else:  # MACE — Gaunt einsums dominate: E*C*9^3 (messages), 2*N*C*9^3
        c = cfg.d_hidden
        fwd = cfg.n_layers * (2 * e * c * 9 * 9 * 9 + 4 * n * c * 9 * 9 * 9
                              + 2 * e * (cfg.n_rbf * c + c * c)
                              + 9 * 2 * n * c * c * 3)
    mult = 3.0 if shape.kind == "train" else 1.0   # fwd + ~2x bwd
    return dict(model_flops=mult * fwd, executed_flops=(mult + 1) * fwd
                if shape.kind == "train" else fwd)   # +1 fwd for remat-ish


def _recsys_flops(arch: Arch, shape: Shape) -> dict:
    cfg = arch.model_cfg
    d = shape.dims
    b = d["batch"]
    t, h, e2 = cfg.seq_len, cfg.gru_dim, 2 * cfg.embed_dim
    gru = 2 * 3 * (e2 + h) * h * t * b * 2            # GRU + AUGRU
    att = 2 * t * b * ((h + e2) * 36 + 36)
    mlp_in = h + 2 * e2 + cfg.embed_dim
    mlp = 2 * b * (mlp_in * 200 + 200 * 80 + 80)
    fwd = gru + att + mlp
    if shape.kind == "train":
        return dict(model_flops=3 * fwd, executed_flops=3 * fwd)
    if shape.kind == "retrieval":
        nc = d["n_candidates"]
        ret = 2 * b * nc * cfg.embed_dim
        return dict(model_flops=fwd + ret, executed_flops=fwd + ret)
    return dict(model_flops=fwd, executed_flops=fwd)


def analytic_flops(arch: Arch, shape: Shape) -> dict:
    """Global (all-device) analytic FLOPs for one step of this cell."""
    if arch.family in ("lm-dense", "lm-moe"):
        return _lm_flops(arch, shape)
    if arch.family == "gnn":
        return _gnn_flops(arch, shape)
    return _recsys_flops(arch, shape)
