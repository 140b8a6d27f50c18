"""Shared functional layers (port of ``repro/models/layers.py``): the dense
layer, the norms, RoPE, grouped-query attention (naive and blockwise),
SwiGLU, the plain MLP and the masked cross-entropy.

Pure functions over dicts of tensors. Initial values come from an explicit
``torch.Generator``: they follow the reference's distributions, not its
values (JAX's threefry stream is not reproduced), so the tests carry the
reference's parameters across. They land on the generator's device unless
``device`` names another (``"meta"``: shapes only, nothing allocated).

Each ``*_specs`` function gives the logical axis names of its init's
parameters, as a flat dict under the same dotted names: the reference's
``(params, specs)`` second half, which ``distributed/sharding.py``
resolves onto a mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import ambient_axes_size, constrain
from repro_torch.models.params import prefixed


def _dense_init(gen: torch.Generator, shape, dtype, scale=None,
                device=None):
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else 1.0 / np.sqrt(max(1, fan_in))
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device if device is None else device)
    return (x * scale).to(dtype)


def dense(gen: torch.Generator, d_in: int, d_out: int,
          dtype=torch.float32, bias: bool = False, device=None) -> dict:
    """{"w": [d_in, d_out] normal * 1/sqrt(d_in)} (+ {"b": zeros})."""
    device = gen.device if device is None else device
    params = {"w": _dense_init(gen, (d_in, d_out), dtype, device=device)}
    if bias:
        params["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return params


def dense_specs(logical=("embed", "mlp"), bias: bool = False) -> dict:
    specs = {"w": tuple(logical)}
    if bias:
        specs["b"] = (logical[-1],)
    return specs


def apply_dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


# --------------------------------------------------------------------- norms


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In float32, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In float32, cast back to ``x``'s dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------- RoPE


def rope_freqs(d_head: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, d_head]; positions: [..., seq] int. The two
    halves of d_head rotate as pairs (not interleaved), in float32."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [d_head/2]
    ang = positions[..., None].to(torch.float32) * freqs       # [..., s, dh/2]
    cos = torch.cos(ang)[..., None, :]                         # [..., s, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention

MASKED = -1e30   # the reference's mask value for scores


def gqa_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                  kv_len_mask=None, seq_pin: bool = True):
    """Grouped-query attention, the reference's einsums.

    q: [B, Sq, Hq, Dh]; k, v: [B, Skv, Hkv, Dh]; Hq = G * Hkv.
    ``q_offset``: absolute position of q[0]; ``kv_len_mask``: optional
    bool[B, Skv] of valid cache slots. Returns [B, Sq, Hq, Dh].

    The scores are formed in the activation dtype and then taken to
    float32, the softmax is float32 and its probabilities go back to
    ``q``'s dtype before the second product, as the reference's.

    The layout pins are the reference's: the group dim on the model axis
    when it divides, else (with ``seq_pin``) the q-seq dim; a partial pin
    on an indivisible dim would force de-sharding, hence the guards. They
    act on DTensors under an ambient mesh (``sharding.constrain``).
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    msize = ambient_axes_size(("model",))
    pin_heads = msize > 1 and g % msize == 0
    pin_seq = (seq_pin and msize > 1 and not pin_heads
               and sq % msize == 0)
    if pin_heads:
        qg = constrain(qg, ("batch", None, None, "heads", None))
    elif pin_seq:
        qg = constrain(qg, ("batch", "kv_seq", None, None, None))
    scale = float(1.0 / np.sqrt(dh))
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(
        torch.float32) * scale
    if pin_heads:
        logits = constrain(logits, ("batch", None, "heads", None, None))
    elif pin_seq:
        logits = constrain(logits, ("batch", None, None, "kv_seq", None))
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = torch.where((qpos >= kpos)[None, None, None], logits,
                             MASKED)
    if kv_len_mask is not None:
        logits = torch.where(kv_len_mask[:, None, None, None, :], logits,
                             MASKED)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    if pin_heads:
        out = constrain(out, ("batch", None, None, "heads", None))
    elif pin_seq:
        out = constrain(out, ("batch", "kv_seq", None, None, None))
    return out.reshape(b, sq, hq, dh)


def gqa_attention_split_kv(q, k, v, *, kv_len_mask):
    """``gqa_attention`` (not causal) over a cache whose slots are split in
    chunks over the model axis of the ambient mesh: ``k``, ``v``
    [B, Skv / M, Hkv, Dh] and ``kv_len_mask`` are this rank's chunk. The
    softmax's max and denominator are reduced over the axis before the
    probabilities are formed, so each rank's share of the second product
    is the unsharded one's, and the shares are summed."""
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, dh)
    scale = float(1.0 / np.sqrt(dh))
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(
        torch.float32) * scale
    logits = torch.where(kv_len_mask[:, None, None, None, :], logits,
                         MASKED)
    m = spmd.model_reduce(logits.amax(-1, keepdim=True), "max")
    e = torch.exp(logits - m)
    probs = (e / spmd.model_reduce(e.sum(-1, keepdim=True), "sum")).to(
        q.dtype)
    out = spmd.model_reduce(torch.einsum("bhgqk,bkhd->bqhgd", probs, v),
                            "sum")
    return out.reshape(b, sq, hq, dh)


def gqa_attention_chunked(q, k, v, *, causal: bool, q_offset: int = 0,
                          q_chunk: int = 2048, kv_chunk: int = 2048):
    """Blockwise GQA attention with an online softmax: O(q_chunk x
    kv_chunk) scores at a time instead of O(Sq x Skv).

    The reference's schedule: for each q block, a pass over the kv blocks
    that carries the running max, the denominator and the weighted
    accumulator, all in float32; the scores come out of the first product
    in float32 (its inputs taken to float32, as the reference asks the dot
    for a float32 result), the probabilities enter the second product in
    ``q``'s dtype. Under ``causal``, a kv block that lies wholly after the
    q block is skipped: there every score is masked, so the reference's
    pass over it leaves the carry as it was (its probabilities are 0 and
    its correction 1).
    """
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    assert sq % q_chunk == 0 and skv % kv_chunk == 0
    nq, nkv = sq // q_chunk, skv // kv_chunk
    scale = float(1.0 / np.sqrt(dh))

    # [b, sq, hkv, g, dh] -> [b, hkv, g, sq, dh]
    qs = q.reshape(b, sq, hkv, g, dh).permute(0, 2, 3, 1, 4)
    k32 = k.to(torch.float32)
    outs = []
    for iq in range(nq):
        qb = qs[:, :, :, iq * q_chunk:(iq + 1) * q_chunk]
        qb32 = qb.to(torch.float32)
        m = torch.full((b, hkv, g, q_chunk), MASKED, dtype=torch.float32,
                       device=q.device)
        den = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32,
                          device=q.device)
        acc = torch.zeros((b, hkv, g, q_chunk, dh), dtype=torch.float32,
                          device=q.device)
        qpos = (iq * q_chunk + q_offset
                + torch.arange(q_chunk, device=q.device))
        for j in range(nkv):
            if causal and j * kv_chunk > iq * q_chunk + q_chunk - 1 + q_offset:
                break
            kb = k32[:, j * kv_chunk:(j + 1) * kv_chunk]
            vb = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            s = torch.einsum("bhgqd,bkhd->bhgqk", qb32, kb) * scale
            if causal:
                kpos = j * kv_chunk + torch.arange(kv_chunk, device=q.device)
                s = torch.where((qpos[:, None] >= kpos[None, :])[
                    None, None, None], s, MASKED)
            m2 = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            den = den * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(q.dtype), vb).to(torch.float32)
            m = m2
        out = acc / torch.clamp(den, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))               # [b, hkv, g, qc, dh]
    out = torch.cat(outs, dim=3)                   # [b, hkv, g, sq, dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dh)


ATTN_CHUNK_THRESHOLD = 8192   # the blockwise path beyond this q length


def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, d_head: int, dtype=torch.float32,
                   qkv_bias: bool = False, device=None) -> dict:
    return {"wq": dense(gen, d_model, n_heads * d_head, dtype, qkv_bias,
                        device),
            "wk": dense(gen, d_model, n_kv * d_head, dtype, qkv_bias,
                        device),
            "wv": dense(gen, d_model, n_kv * d_head, dtype, qkv_bias,
                        device),
            "wo": dense(gen, n_heads * d_head, d_model, dtype, device=device)}


def attention_specs(qkv_bias: bool = False) -> dict:
    return {**prefixed("wq", dense_specs(("embed", "heads"), qkv_bias)),
            **prefixed("wk", dense_specs(("embed", "kv"), qkv_bias)),
            **prefixed("wv", dense_specs(("embed", "kv"), qkv_bias)),
            **prefixed("wo", dense_specs(("heads", "embed")))}


# --------------------------------------------------------------- SwiGLU MLP


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32, device=None) -> dict:
    return {"w1": dense(gen, d_model, d_ff, dtype, device=device),
            "w3": dense(gen, d_model, d_ff, dtype, device=device),
            "w2": dense(gen, d_ff, d_model, dtype, device=device)}


def swiglu_specs() -> dict:
    return {"w1.w": ("embed", "mlp"), "w3.w": ("embed", "mlp"),
            "w2.w": ("mlp", "embed")}


def swiglu(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ p["w1"]["w"])
            * (x @ p["w3"]["w"])) @ p["w2"]["w"]


def mlp_init(gen: torch.Generator, sizes, dtype=torch.float32,
             device=None) -> list:
    """Plain MLP used by GNN and recsys heads, sizes = [d0, d1, ..., dk]:
    a list of {"w", "b"} dense layers."""
    return [dense(gen, sizes[i], sizes[i + 1], dtype, bias=True,
                  device=device)
            for i in range(len(sizes) - 1)]


def mlp_specs(n_dense: int) -> dict:
    """The specs of an ``mlp_init`` of ``n_dense`` layers: ("embed",
    "mlp") into the first, ("mlp", "mlp") after it."""
    return {f"{i}.{k}": v for i in range(n_dense)
            for k, v in dense_specs(("embed", "mlp") if i == 0
                                    else ("mlp", "mlp"), bias=True).items()}


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
    """Mean cross-entropy in float32. logits [..., V], labels int[...].
    Under a split mesh, this rank's share (``spmd.split_mean``)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    return spmd.split_mean(nll, mask)
