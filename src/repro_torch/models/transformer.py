"""Decoder-only transformer, dense and MoE, with train, prefill and decode
paths (port of ``repro/models/transformer.py``).

  * GQA + RoPE + SwiGLU (or the MoE FFN) + RMSNorm, optional QKV bias;
  * the per-layer parameters are stacked ``[n_layers, ...]`` under
    ``layers.*``, as the reference stacks them for its layer scan; the
    forward walks them with ``torch.unbind``, so the backward stacks one
    gradient a tensor;
  * ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint`` with nothing saveable;
  * serving: ``lm_prefill`` builds the KV cache, ``lm_decode_step`` writes
    one token's keys and values into it in place (the reference donates
    the cache to the same end) and attends over its filled slots;
  * a float8 cache (``kv_cache_dtype="float8_e4m3fn"``) is written through
    ``to_float8_e4m3fn``, the reference's cast, and read back in the
    activation dtype before the dots.

``seq_parallel_residual`` and ``attn_seq_pin`` place tensors on a device
mesh in the reference (sequence-parallel residuals, pinned score layouts)
through ``constrain``, as here; on one device, and on the plain blocks the
sharded step hands a rank, they change nothing.

Under the sharded step (``train/sharded.py``, ``distributed/spmd.py``) a
rank holds a block of the rows and, in training and prefill, one chunk of
the sequence over the model axis: its positions start at the chunk's
offset, its keys and values are all-gathered over the axis for the
attention (the cache keeps its own chunk), a decode step attends over its
chunk of the cache with the softmax reduced over the axis, and the
parameters arrive as shards that ``spmd.full`` gathers where they are used
(one layer at a time, again in the layer's recomputation).

Parameters are a flat dict named as the reference's tree: ``embed``
[V, d], ``layers.ln1.scale`` [L, d], ``layers.attn.wq.w`` [L, d, H * Dh]
(``.b`` with ``qkv_bias``), ``layers.mlp.w1.w`` or ``layers.moe.router``
[L, d, E], ``layers.moe.w1`` [L, E, d, f], ..., ``ln_f.scale``, ``head``
[d, V].
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import constrain
from repro_torch.models import layers as L
from repro_torch.models.moe import (MoEConfig, TokenLayout, moe_ffn,
                                    moe_init, moe_specs)
from repro_torch.models.params import flatten, prefixed, unflatten

# float8_e4m3fn's largest finite value is 448; the reference's cast (round
# to nearest even) gives NaN for whatever rounds past it, i.e. above the
# midpoint 464 between 448 and the next step, 480
FP8_E4M3_NAN_ABOVE = 464.0


def to_float8_e4m3fn(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to float8_e4m3fn as the reference casts it: in range,
    round to nearest even (torch's cast does the same); a value whose
    magnitude is above 464 (and inf) becomes NaN with its sign (0x7f /
    0xff), where torch's cast saturates to +-448."""
    bits = x.to(torch.float8_e4m3fn).view(torch.uint8)
    nan = (torch.signbit(x).to(torch.uint8) << 7) | 0x7f
    bits = torch.where(x.abs() > FP8_E4M3_NAN_ABOVE, nan, bits)
    return bits.view(torch.float8_e4m3fn)


def _to_cache(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float8_e4m3fn:
        return to_float8_e4m3fn(t)
    return t.to(dtype)


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 500000.0
    qkv_bias: bool = False
    moe: MoEConfig | None = None
    dtype: str = "float32"
    param_dtype: str = "float32"
    remat: bool = True
    # sharding only (a mesh's sequence-parallel residual stream): no effect
    # on one device
    seq_parallel_residual: bool = False
    # KV cache storage dtype (serving); None means the activation dtype
    kv_cache_dtype: str | None = None
    # sharding only (pins the score layout on a mesh): no effect here
    attn_seq_pin: bool = True

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def cache_dtype(self) -> torch.dtype:
        return getattr(torch, self.kv_cache_dtype or self.dtype)

    def param_count(self) -> int:
        d, v = self.d_model, self.vocab
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d
        if self.moe is not None:
            ffn = self.moe.num_experts * 3 * d * self.moe.d_ff_expert \
                + d * self.moe.num_experts
        else:
            ffn = 3 * d * self.d_ff
        return self.n_layers * (attn + ffn + 2 * d) + 2 * v * d + d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts)."""
        d, v = self.d_model, self.vocab
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.d_head \
            + self.n_heads * self.d_head * d
        if self.moe is not None:
            ffn = self.moe.top_k * 3 * d * self.moe.d_ff_expert \
                + d * self.moe.num_experts
        else:
            ffn = 3 * d * self.d_ff
        return self.n_layers * (attn + ffn + 2 * d) + 2 * v * d + d


# ------------------------------------------------------------------- init


def _layer_init(gen: torch.Generator, cfg: LMConfig, device) -> dict:
    pdt = getattr(torch, cfg.param_dtype)
    p = {"ln1": L.rmsnorm_init(cfg.d_model, pdt, device),
         "ln2": L.rmsnorm_init(cfg.d_model, pdt, device),
         "attn": L.attention_init(gen, cfg.d_model, cfg.n_heads,
                                  cfg.n_kv_heads, cfg.d_head, pdt,
                                  qkv_bias=cfg.qkv_bias, device=device)}
    if cfg.moe is not None:
        p["moe"] = moe_init(gen, cfg.d_model, cfg.moe, pdt, device)
    else:
        p["mlp"] = L.swiglu_init(gen, cfg.d_model, cfg.d_ff, pdt, device)
    return flatten(p)


def init_lm(gen: torch.Generator, cfg: LMConfig, device=None) -> dict:
    """Parameters drawn from ``gen`` on its device, or on ``device`` (the
    reference's distributions, not its values): the layers drawn one by
    one and stacked."""
    device = gen.device if device is None else device
    pdt = getattr(torch, cfg.param_dtype)
    embed = L._dense_init(gen, (cfg.vocab, cfg.d_model), pdt, scale=0.02,
                          device=device)
    per_layer = [_layer_init(gen, cfg, device) for _ in range(cfg.n_layers)]
    params = {"embed": embed}
    for name in list(per_layer[0]):
        params[f"layers.{name}"] = torch.stack([lp[name] for lp in per_layer])
        for lp in per_layer:
            del lp[name]
    params["ln_f.scale"] = L.rmsnorm_init(cfg.d_model, pdt, device)["scale"]
    params["head"] = L._dense_init(gen, (cfg.d_model, cfg.vocab), pdt,
                                   device=device)
    return params


def lm_param_specs(cfg: LMConfig) -> dict:
    """Logical axes of ``init_lm``'s parameters; a stacked layer tensor
    leads with None (its layer dimension)."""
    layer = {"ln1.scale": ("embed",), "ln2.scale": ("embed",),
             **prefixed("attn", L.attention_specs(cfg.qkv_bias)),
             **(prefixed("moe", moe_specs()) if cfg.moe is not None
                else prefixed("mlp", L.swiglu_specs()))}
    return {"embed": ("vocab", "embed"),
            **{f"layers.{k}": (None,) + v for k, v in layer.items()},
            "ln_f.scale": ("embed",), "head": ("embed", "vocab")}


def layer_params(params: dict, n_layers: int) -> list[dict]:
    """Layer i's parameters as the reference's nest, from one
    ``torch.unbind`` of each stacked tensor."""
    names = [k for k in params if k.startswith("layers.")]
    slices = [torch.unbind(params[k], 0) for k in names]
    return [unflatten({k[len("layers."):]: s[i]
                       for k, s in zip(names, slices)})
            for i in range(n_layers)]


# ---------------------------------------------------------------- forward


def _full_layer(lp: dict) -> dict:
    """One layer's parameters whole from their shards (``spmd.full``)."""
    return unflatten({k: spmd.full(f"layers.{k}", v, stacked=True)
                      for k, v in flatten(lp).items()})


def _embed(params: dict, tokens: torch.Tensor, cfg: LMConfig):
    # F.embedding: its backward sums a repeated token's rows in a fixed
    # order on the card (no float atomics)
    return F.embedding(tokens.long(), spmd.full("embed", params["embed"])
                       ).to(cfg.activation_dtype)


def _logits(params: dict, x: torch.Tensor, cfg: LMConfig):
    x = L.rmsnorm({"scale": spmd.full("ln_f.scale", params["ln_f.scale"])},
                  x)
    logits = x @ spmd.full("head", params["head"]).to(cfg.activation_dtype)
    return constrain(logits, ("batch",) + (None,) * (logits.dim() - 2)
                     + ("vocab",))


def _ffn(lp: dict, x2: torch.Tensor, cfg: LMConfig, seq_split: bool = True):
    if cfg.moe is not None:
        b, s, d = x2.shape
        y, aux = moe_ffn(lp["moe"], x2.reshape(b * s, d), cfg.moe,
                         TokenLayout(b, seq_split))
        return y.reshape(b, s, d), aux
    return L.swiglu(lp["mlp"], x2), torch.zeros((), dtype=torch.float32,
                                                device=x2.device)


def _qkv(lp: dict, x1: torch.Tensor, cfg: LMConfig, positions):
    b, s, _ = x1.shape
    q = L.apply_dense(lp["attn"]["wq"], x1).reshape(b, s, cfg.n_heads,
                                                    cfg.d_head)
    k = L.apply_dense(lp["attn"]["wk"], x1).reshape(b, s, cfg.n_kv_heads,
                                                    cfg.d_head)
    v = L.apply_dense(lp["attn"]["wv"], x1).reshape(b, s, cfg.n_kv_heads,
                                                    cfg.d_head)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _self_attn(lp: dict, x1: torch.Tensor, cfg: LMConfig, pos0: int = 0):
    """Causal attention over the sequence from position ``pos0`` on (this
    rank's chunk, which attends over every chunk up to its own): (output,
    (k, v) of the chunk)."""
    b, s, _ = x1.shape
    positions = torch.arange(pos0, pos0 + s, dtype=torch.int32,
                             device=x1.device)[None]
    q, k, v = _qkv(lp, x1, cfg, positions)
    k_all, v_all = spmd.gather_model(k, 1), spmd.gather_model(v, 1)
    if k_all.shape[1] > L.ATTN_CHUNK_THRESHOLD:
        o = L.gqa_attention_chunked(q, k_all, v_all, causal=True,
                                    q_offset=pos0)
    else:
        o = L.gqa_attention(q, k_all, v_all, causal=True, q_offset=pos0,
                            seq_pin=cfg.attn_seq_pin)
    return L.apply_dense(lp["attn"]["wo"], o.reshape(b, s, -1)), (k, v)


def _block(x: torch.Tensor, lp: dict, cfg: LMConfig, pos0: int = 0):
    lp = _full_layer(lp)
    if cfg.seq_parallel_residual:
        x = constrain(x, ("batch", "kv_seq", None))
    a, _ = _self_attn(lp, L.rmsnorm(lp["ln1"], x), cfg, pos0)
    x = x + a
    f, aux = _ffn(lp, L.rmsnorm(lp["ln2"], x), cfg)
    x = x + f
    if cfg.seq_parallel_residual:
        x = constrain(x, ("batch", "kv_seq", None))
    return x, aux


def lm_forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
               pos0: int = 0):
    """tokens int[B, S] from position ``pos0`` -> (logits [B, S, V] in the
    activation dtype, the layers' summed aux loss). With ``cfg.remat`` and
    gradients on, each layer is recomputed in the backward."""
    x = constrain(_embed(params, tokens, cfg), ("batch", None, None))
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for lp in layer_params(params, cfg.n_layers):
        if remat:
            x, aux = checkpoint(_block, x, lp, cfg, pos0,
                                use_reentrant=False)
        else:
            x, aux = _block(x, lp, cfg, pos0)
        auxs.append(aux)
    return _logits(params, x, cfg), torch.stack(auxs).sum()


def lm_loss(params: dict, batch: dict, cfg: LMConfig):
    """Next-token cross-entropy (float32) plus the aux loss; metrics
    ``xent`` and ``aux``. Under a split mesh, this rank's chunk of the
    sequence (``spmd.seq_slice``) predicts the labels one position on, and
    the loss is its share."""
    tokens, labels = batch["tokens"], batch["labels"]
    off, c = spmd.seq_slice(tokens.shape[1])
    logits, aux = lm_forward(params, tokens[:, off:off + c], cfg, pos0=off)
    target = labels[:, off + 1:off + c + 1]
    mask = batch.get("mask", None)
    if mask is not None:
        mask = mask[:, off + 1:off + c + 1]
    loss = L.softmax_xent(logits[:, :target.shape[1]], target, mask)
    return loss + aux, {"xent": loss, "aux": aux}


# ------------------------------------------------------------------ serving


# a cache layer's logical axes, [B, S, KV, Dh]
KV_SPEC = ("batch", "kv_seq", "kv_heads", None)


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, device=None):
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return (torch.zeros(shape, dtype=cfg.cache_dtype, device=device),
            torch.zeros(shape, dtype=cfg.cache_dtype, device=device))


def lm_prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig,
               max_len: int | None = None):
    """tokens int[B, S] -> (last token's logits [B, V], cache).

    The cache is ([L, B, max_len, KV, Dh],) * 2 in ``cfg.cache_dtype``,
    the prompt's keys and values in its first S slots and zeros after
    (``max_len`` defaults to S: the reference's cache; a larger one is the
    reference's cache padded with zeros for the decode steps). Under a
    split mesh the rank's cache is its chunk of the sequence (no
    ``max_len``)."""
    b, s = tokens.shape
    off, c = spmd.seq_slice(s)
    if c != s and max_len is not None:
        raise ValueError("a padded cache on a split mesh")
    cache = init_kv_cache(cfg, b, max_len or c, tokens.device)
    x = _embed(params, tokens[:, off:off + c], cfg)
    for i, lp in enumerate(layer_params(params, cfg.n_layers)):
        lp = _full_layer(lp)
        a, (k, v) = _self_attn(lp, L.rmsnorm(lp["ln1"], x), cfg, off)
        x = x + a
        f, _ = _ffn(lp, L.rmsnorm(lp["ln2"], x), cfg)
        x = x + f
        # the cache layers are the step's outputs: pinned model-axis sharded
        cache[0][i, :, :c] = constrain(_to_cache(k, cfg.cache_dtype),
                                       KV_SPEC)
        cache[1][i, :, :c] = constrain(_to_cache(v, cfg.cache_dtype),
                                       KV_SPEC)
    # the prompt's last token is the last chunk's
    last = spmd.gather_model(_logits(params, x[:, -1:], cfg), 1)[:, -1]
    return last, cache


def lm_decode_step(params: dict, token: torch.Tensor, cache, cache_len,
                   cfg: LMConfig):
    """One decode step.

    token int[B, 1]; cache ([L, B, S, KV, Dh],) * 2; cache_len (int or an
    int scalar tensor): the number of filled slots. The token's key and
    value go into slot ``cache_len`` of ``cache``, in place; attention
    reads the slots up to and including it. Returns (logits [B, V], the
    cache). Under a split mesh with a model axis, ``cache`` is the rank's
    chunk of the slots (``gqa_attention_split_kv``)."""
    cache_len = int(cache_len)
    b = token.shape[0]
    max_len = cache[0].shape[2]
    adt = cfg.activation_dtype
    sp = spmd.split()
    split_kv = sp is not None and sp.model > 1
    off = sp.model_index * max_len if split_kv else 0
    x = _embed(params, token, cfg)
    positions = torch.full((1, 1), cache_len, dtype=torch.int32,
                           device=token.device)
    slot_mask = (torch.arange(off, off + max_len, device=token.device)
                 <= cache_len)[None].expand(b, max_len)
    at = cache_len - off
    for lp, k_l, v_l in zip(layer_params(params, cfg.n_layers),
                            torch.unbind(cache[0], 0),
                            torch.unbind(cache[1], 0)):
        lp = _full_layer(lp)
        q, kn, vn = _qkv(lp, L.rmsnorm(lp["ln1"], x), cfg, positions)
        if not split_kv or 0 <= at < max_len:
            k_l[:, at:at + 1] = _to_cache(kn, k_l.dtype)
            v_l[:, at:at + 1] = _to_cache(vn, v_l.dtype)
        k_l, v_l = constrain(k_l, KV_SPEC), constrain(v_l, KV_SPEC)
        if split_kv:
            o = L.gqa_attention_split_kv(q, k_l.to(adt), v_l.to(adt),
                                         kv_len_mask=slot_mask)
        else:
            o = L.gqa_attention(q, k_l.to(adt), v_l.to(adt), causal=False,
                                kv_len_mask=slot_mask,
                                seq_pin=cfg.attn_seq_pin)
        x = x + L.apply_dense(lp["attn"]["wo"], o.reshape(b, 1, -1))
        f, _ = _ffn(lp, L.rmsnorm(lp["ln2"], x), cfg, seq_split=False)
        x = x + f
    return _logits(params, x, cfg)[:, 0], cache
