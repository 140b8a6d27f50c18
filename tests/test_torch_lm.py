"""The port's LM layers and transformer against the JAX package's, on the
CPU: the norms, RoPE, grouped-query attention (naive and blockwise),
SwiGLU, the float8 cast, and ``lm_forward``, ``lm_loss`` with its
gradients, ``lm_prefill`` and ``lm_decode_step`` on a dense GQA, an MoE, a
QKV-bias and a float8-cache config, from the reference's parameters
carried across by name (``params_from_numpy``).

Tolerances. float32: 1e-5 of the largest magnitude of each output
(logits, attention outputs, every gradient tensor), losses within rtol
1e-5; the two packages take the same products in other orders. RoPE:
atol 2e-5 (sin and cos of angles up to 4e4 rad differ in their last bits
between the two libraries). bfloat16 activations: 2e-2 of the largest
magnitude (a few roundings of bfloat16's 8-bit mantissa). The float8 cast
is bit-equal. The reference's functions are jitted, once per module.
"""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import MoEConfig
from repro_torch.models.params import params_from_numpy

F32 = 1e-5
BF16 = 2e-2


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    mod = importlib.import_module
    return SimpleNamespace(jax=mod("jax"), jnp=mod("jax.numpy"),
                           L=mod("repro.models.layers"),
                           T=mod("repro.models.transformer"),
                           moe=mod("repro.models.moe"))


def rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def j(ref, a, dtype=None):
    out = ref.jnp.asarray(a)
    return out if dtype is None else out.astype(dtype)


def assert_scaled(got, want, tol, msg=""):
    """|got - want| within tol of want's largest magnitude."""
    g = got.detach().to(torch.float64)
    w = torch.from_numpy(np.asarray(want, dtype=np.float64))
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    err = float((g - w).abs().max())
    assert err <= tol * max(float(w.abs().max()), 1e-12), (msg, err)


# -------------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(ref, dtype):
    x = rand(0, (3, 5, 16), 3.0)
    scale, bias = rand(1, (16,)), rand(2, (16,))
    tol = F32 if dtype == "float32" else BF16
    xj, xt = j(ref, x, dtype), t(x, getattr(torch, dtype))
    got = L.rmsnorm({"scale": t(scale)}, xt)
    assert got.dtype == xt.dtype
    assert_scaled(got, ref.L.rmsnorm({"scale": j(ref, scale)}, xj).astype(
        "float32"), tol)
    got = L.layernorm({"scale": t(scale), "bias": t(bias)}, xt)
    want = ref.L.layernorm({"scale": j(ref, scale), "bias": j(ref, bias)},
                           xj)
    assert_scaled(got, want.astype("float32"), tol)
    assert torch.equal(L.rmsnorm_init(16)["scale"], torch.ones(16))
    assert set(L.layernorm_init(16)) == {"scale", "bias"}


@pytest.mark.parametrize("theta", [10000.0, 1000000.0])
def test_apply_rope_matches_reference(ref, theta):
    x = rand(3, (2, 7, 3, 16))
    pos = np.random.default_rng(4).integers(0, 40000, (2, 7)).astype(
        np.int32)
    np.testing.assert_allclose(
        L.rope_freqs(16, theta).numpy(),
        np.asarray(ref.L.rope_freqs(16, theta)), rtol=1e-6)
    got = L.apply_rope(t(x), t(pos), theta)
    want = ref.L.apply_rope(j(ref, x), j(ref, pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_rope_relative_property():
    """<q_i, k_j> depends only on i - j (tests/test_models.py's check)."""
    q, k = t(rand(0, (1, 1, 1, 32))), t(rand(1, (1, 1, 1, 32)))

    def dot_at(i, jj):
        qi = L.apply_rope(q, torch.tensor([[i]]), 10000.0)
        kj = L.apply_rope(k, torch.tensor([[jj]]), 10000.0)
        return float(torch.sum(qi * kj))
    assert abs(dot_at(5, 3) - dot_at(105, 103)) < 1e-3


ATTN_CASES = {
    "causal_gqa": dict(shape=(2, 24, 8, 2, 16), causal=True),
    "causal_mha_offset": dict(shape=(1, 8, 4, 4, 16), skv=20, causal=True,
                              q_offset=12),
    "kv_mask": dict(shape=(3, 1, 6, 2, 16), skv=40, causal=False,
                    mask=True),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_gqa_attention_matches_reference(ref, case, dtype):
    c = ATTN_CASES[case]
    b, sq, hq, hkv, dh = c["shape"]
    skv = c.get("skv", sq)
    q, k, v = (rand(5, (b, sq, hq, dh)), rand(6, (b, skv, hkv, dh)),
               rand(7, (b, skv, hkv, dh)))
    kw = dict(causal=c["causal"], q_offset=c.get("q_offset", 0))
    mask = None
    if c.get("mask"):
        lens = np.array([40, 17, 1])
        mask = np.arange(skv)[None] < lens[:, None]
    dt = getattr(torch, dtype)
    got = L.gqa_attention(t(q, dt), t(k, dt), t(v, dt),
                          kv_len_mask=None if mask is None else t(mask), **kw)
    want = ref.L.gqa_attention(
        j(ref, q, dtype), j(ref, k, dtype), j(ref, v, dtype),
        kv_len_mask=None if mask is None else j(ref, mask), **kw)
    assert got.dtype == dt
    assert_scaled(got, np.asarray(want.astype("float32")),
                  F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("b,sq,hq,hkv,dh", [(2, 256, 8, 2, 32),
                                            (1, 512, 4, 4, 16)])
def test_chunked_attention_matches_reference_and_naive(ref, b, sq, hq, hkv,
                                                       dh):
    """At tests/test_models.py's shapes and chunks (q 64, kv 128): against
    the reference's blockwise path, and against the port's naive path
    within that test's tolerance (rtol 2e-4, atol 2e-5)."""
    q, k, v = (rand(8, (b, sq, hq, dh)), rand(9, (b, sq, hkv, dh)),
               rand(10, (b, sq, hkv, dh)))
    got = L.gqa_attention_chunked(t(q), t(k), t(v), causal=True,
                                  q_chunk=64, kv_chunk=128)
    want = ref.jax.jit(lambda q, k, v: ref.L.gqa_attention_chunked(
        q, k, v, causal=True, q_chunk=64, kv_chunk=128))(
            j(ref, q), j(ref, k), j(ref, v))
    assert_scaled(got, want, F32)
    naive = L.gqa_attention(t(q), t(k), t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), rtol=2e-4,
                               atol=2e-5)
    with pytest.raises(AssertionError):
        L.gqa_attention_chunked(t(q), t(k), t(v), causal=True, q_chunk=48)


def test_chunked_attention_bfloat16_matches_reference(ref):
    """bfloat16 inputs: float32 scores and carry, bfloat16 probabilities
    into the second product, as the reference's."""
    q = rand(11, (1, 128, 4, 16))
    k, v = rand(12, (1, 128, 2, 16)), rand(13, (1, 128, 2, 16))
    bf = torch.bfloat16
    got = L.gqa_attention_chunked(t(q, bf), t(k, bf), t(v, bf), causal=True,
                                  q_chunk=32, kv_chunk=64)
    want = ref.L.gqa_attention_chunked(
        j(ref, q, "bfloat16"), j(ref, k, "bfloat16"), j(ref, v, "bfloat16"),
        causal=True, q_chunk=32, kv_chunk=64)
    assert got.dtype == bf
    assert_scaled(got, np.asarray(want.astype("float32")), BF16)


def test_swiglu_matches_reference(ref):
    x = rand(14, (4, 6, 16))
    p = {"w1": {"w": rand(15, (16, 40))}, "w3": {"w": rand(16, (16, 40))},
         "w2": {"w": rand(17, (40, 16))}}
    got = L.swiglu({k: {"w": t(v["w"])} for k, v in p.items()}, t(x))
    want = ref.L.swiglu({k: {"w": j(ref, v["w"])} for k, v in p.items()},
                        j(ref, x))
    assert_scaled(got, want, F32)
    gen = torch.Generator().manual_seed(0)
    init = L.swiglu_init(gen, 16, 40)
    assert {k: tuple(v["w"].shape) for k, v in init.items()} == {
        "w1": (16, 40), "w3": (16, 40), "w2": (40, 16)}
    att = L.attention_init(gen, 16, 4, 2, 8, qkv_bias=True)
    assert att["wk"]["w"].shape == (16, 16) and att["wq"]["b"].shape == (32,)
    assert "b" not in att["wo"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_cast_matches_reference_bit_for_bit(ref, dtype):
    """Over +-1000, densely around 448-480 on both sides of 464, with inf,
    zeros and subnormals: torch's own cast saturates there; the helper
    gives the reference's NaN."""
    rng = np.random.default_rng(18)
    x = np.concatenate([
        np.linspace(-1000, 1000, 20001), rng.uniform(-1000, 1000, 20000),
        np.linspace(440, 490, 5001), -np.linspace(440, 490, 5001),
        [464.0, -464.0, np.nextafter(464.0, 1e9), np.inf, -np.inf, 0.0,
         -0.0, 1e-9, 2.0 ** -9, -(2.0 ** -7)]]).astype(np.float32)
    want = np.asarray(j(ref, x, dtype).astype("float8_e4m3fn")).view(
        np.uint8)
    got = T.to_float8_e4m3fn(t(x, getattr(torch, dtype)))
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want)
    over = np.abs(x.astype(np.float64)) > 464.0
    if dtype == "float32":
        assert over.any() and np.all(want[over] & 0x7f == 0x7f)
        # torch's own cast differs exactly there
        plain = t(x).to(torch.float8_e4m3fn).view(torch.uint8).numpy()
        assert np.all(plain[~over] == want[~over])
        assert not np.any(plain[over & np.isfinite(x)] == want[
            over & np.isfinite(x)])


# --------------------------------------------------------------- transformer

LM_CASES = {
    "dense_gqa": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_head=16, d_ff=96, vocab=128),
    "moe": dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
                d_ff=0, vocab=96, moe=(4, 2, 24, 2.0)),
    "qkv_bias_mha": dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
                         d_head=8, d_ff=64, vocab=80, qkv_bias=True,
                         rope_theta=1e6),
    "fp8_cache": dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                      d_head=8, d_ff=64, vocab=64,
                      kv_cache_dtype="float8_e4m3fn"),
}
B, S, NEW = 2, 12, 3


def lm_cfgs(ref, case):
    # remat off: the reference's gradient compiles faster without it; the
    # train steps of the reduced archs run with it
    kw = dict(LM_CASES[case], name=case, remat=False)
    moe = kw.pop("moe", None)
    kj, kt = dict(kw), dict(kw)
    if moe is not None:
        e, k, f, cf = moe
        kj["moe"] = ref.moe.MoEConfig(num_experts=e, top_k=k, d_ff_expert=f,
                                      capacity_factor=cf)
        kt["moe"] = MoEConfig(num_experts=e, top_k=k, d_ff_expert=f,
                              capacity_factor=cf)
    return ref.T.LMConfig(**kj), T.LMConfig(**kt)


@pytest.fixture(scope="module")
def lm_ref(ref):
    """Per case: the reference's parameters, tokens, forward logits and
    aux, loss and gradients, prefill logits and cache, and NEW decode
    steps' logits and caches (two jitted functions a case)."""
    jax, jnp = ref.jax, ref.jnp

    def train_and_prefill(p, toks, cfg_j):
        logits, aux = ref.T.lm_forward(p, toks[:, :S], cfg_j)
        batch = {"tokens": toks[:, :S], "labels": toks[:, :S]}
        (loss, met), g = jax.value_and_grad(
            lambda p, b: ref.T.lm_loss(p, b, cfg_j), has_aux=True)(p, batch)
        pre, cache = ref.T.lm_prefill(p, toks[:, :S], cfg_j)
        cache = tuple(jnp.pad(c, ((0, 0), (0, 0), (0, NEW), (0, 0),
                                  (0, 0))) for c in cache)
        return logits, aux, loss, met["xent"], g, pre, cache

    out = {}
    for case in LM_CASES:
        cfg_j, _ = lm_cfgs(ref, case)
        p, _ = ref.T.init_lm(jax.random.PRNGKey(1), cfg_j)
        toks = np.random.default_rng(2).integers(
            0, cfg_j.vocab, (B, S + NEW)).astype(np.int32)
        logits, aux, loss, xent, g, pre, cache = jax.jit(
            lambda p, x: train_and_prefill(p, x, cfg_j))(p, toks)
        decode = jax.jit(lambda p, tok, c, n: ref.T.lm_decode_step(
            p, tok, c, n, cfg_j))
        steps = []
        for i in range(NEW):
            lg, cache = decode(p, toks[:, S + i:S + i + 1], cache,
                               jnp.int32(S + i))
            steps.append(lg)
        logits, g, cache = jax.device_get((logits, g, cache))
        out[case] = dict(
            params=params_from_numpy(jax.device_get(p), "cpu"), toks=toks,
            logits=np.asarray(logits, np.float32), aux=float(aux),
            loss=float(loss), xent=float(xent),
            grads=params_from_numpy(g, "cpu"), prefill=np.asarray(pre),
            cache=[c.view(np.uint8) if "float8" in str(c.dtype) else c
                   for c in cache],
            steps=[np.asarray(s) for s in steps])
    return out


def port_loss_grads(params, toks, cfg):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    batch = {"tokens": toks, "labels": toks}
    loss, met = T.lm_loss(leaves, batch, cfg)
    got = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), met, dict(zip(leaves, got))


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_forward_and_loss_match_reference(ref, lm_ref, case):
    r = lm_ref[case]
    _, cfg = lm_cfgs(ref, case)
    p = r["params"]
    assert set(p) == set(r["grads"])
    assert p["layers.attn.wq.w"].shape[0] == cfg.n_layers
    toks = t(r["toks"])
    logits, aux = T.lm_forward(p, toks[:, :S], cfg)
    assert logits.shape == (B, S, cfg.vocab)
    assert_scaled(logits, r["logits"], F32)
    np.testing.assert_allclose(float(aux), r["aux"], rtol=1e-5, atol=1e-7)
    loss, met, grads = port_loss_grads(p, toks[:, :S], cfg)
    np.testing.assert_allclose(float(loss), r["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(met["xent"].detach()), r["xent"],
                               rtol=1e-5)
    for name, g in grads.items():
        assert_scaled(g, r["grads"][name].numpy(), F32, name)


@pytest.mark.parametrize("case", sorted(LM_CASES))
def test_lm_prefill_and_decode_match_reference(ref, lm_ref, case):
    """Prefill into a cache with room for NEW tokens, then NEW decode steps
    written in place: logits within F32, the cache (float8 bit for bit)."""
    r = lm_ref[case]
    _, cfg = lm_cfgs(ref, case)
    toks = t(r["toks"])
    logits, cache = T.lm_prefill(r["params"], toks[:, :S], cfg,
                                 max_len=S + NEW)
    assert cache[0].dtype == cfg.cache_dtype
    assert cache[0].shape == (cfg.n_layers, B, S + NEW, cfg.n_kv_heads,
                              cfg.d_head)
    assert_scaled(logits, r["prefill"], F32)
    for i in range(NEW):
        logits, out = T.lm_decode_step(r["params"], toks[:, S + i:S + i + 1],
                                       cache, S + i, cfg)
        assert out[0] is cache[0] and out[1] is cache[1]
        assert_scaled(logits, r["steps"][i], F32, f"step {i}")
    for got, want in zip(cache, r["cache"]):
        if cfg.cache_dtype == torch.float8_e4m3fn:
            # cached from the port's own keys and values: float8 steps
            # are 6 % apart, so a key within 1e-5 may round to the next
            diff = got.view(torch.uint8).numpy() != want
            assert diff.mean() < 1e-3, diff.mean()
        else:
            assert_scaled(got, want, F32)


@pytest.mark.parametrize("case", ["dense_gqa", "moe"])
def test_decode_equals_forward(ref, lm_ref, case):
    """tests/test_models.py's check on the port alone: the prefill's logits
    and each decode step's equal the forward pass's last row over the
    tokens so far (rtol, atol 2e-4)."""
    r = lm_ref[case]
    _, cfg = lm_cfgs(ref, case)
    toks = t(r["toks"])
    logits, cache = T.lm_prefill(r["params"], toks[:, :S], cfg,
                                 max_len=S + NEW)
    for i in range(NEW + 1):
        full, _ = T.lm_forward(r["params"], toks[:, :S + i], cfg)
        np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(),
                                   rtol=2e-4, atol=2e-4)
        if i < NEW:
            logits, cache = T.lm_decode_step(
                r["params"], toks[:, S + i:S + i + 1], cache, S + i, cfg)


def test_fp8_cache_decode_close(ref, lm_ref):
    """tests/test_models.py's check: a float8 cache's decode logits
    correlate above 0.98 with the full-precision forward's."""
    r = lm_ref["fp8_cache"]
    _, cfg = lm_cfgs(ref, "fp8_cache")
    toks = t(r["toks"])
    _, cache = T.lm_prefill(r["params"], toks[:, :S], cfg, max_len=S + 1)
    assert cache[0].dtype == torch.float8_e4m3fn
    logits, _ = T.lm_decode_step(r["params"], toks[:, S:S + 1], cache, S, cfg)
    full, _ = T.lm_forward(r["params"], toks[:, :S + 1], cfg)
    corr = np.corrcoef(logits.numpy().ravel(), full[:, -1].numpy().ravel())
    assert corr[0, 1] > 0.98


@pytest.mark.parametrize("case", ["dense_gqa", "moe"])
def test_remat_gradients_equal_plain(ref, lm_ref, case):
    import dataclasses
    r = lm_ref[case]
    _, cfg = lm_cfgs(ref, case)
    toks = t(r["toks"])[:, :S]
    loss_r, _, g_r = port_loss_grads(
        r["params"], toks, dataclasses.replace(cfg, remat=True))
    loss_p, _, g_p = port_loss_grads(r["params"], toks, cfg)
    assert float(loss_r) == float(loss_p)
    for name in g_r:
        assert torch.equal(g_r[name], g_p[name]), name


def test_init_lm_shapes_and_counts(ref):
    cfg_j, cfg = lm_cfgs(ref, "moe")
    p = T.init_lm(torch.Generator().manual_seed(0), cfg)
    p_j, _ = ref.T.init_lm(ref.jax.random.PRNGKey(0), cfg_j)
    want = params_from_numpy(ref.jax.device_get(p_j), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in want.items()}
    assert p["layers.moe.router"].dtype == torch.float32
    assert sum(v.numel() for v in p.values()) == cfg.param_count()
    assert cfg.active_param_count() == cfg_j.active_param_count()
    bf = T.LMConfig(name="b", n_layers=1, d_model=8, n_heads=2,
                    n_kv_heads=1, d_head=4, d_ff=8, vocab=16,
                    dtype="bfloat16", param_dtype="bfloat16")
    pb = T.init_lm(torch.Generator().manual_seed(0), bf)
    assert pb["layers.mlp.w1.w"].dtype == torch.bfloat16
    assert bf.activation_dtype == torch.bfloat16 == bf.cache_dtype
    kv = T.init_kv_cache(bf, 3, 5)
    assert kv[0].shape == (1, 3, 5, 1, 4) and kv[0].dtype == torch.bfloat16
