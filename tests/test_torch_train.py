"""The port's training path against the JAX package's: the AdamW update and
gradient clipping, three train steps of the reduced gcn-cora, the Trainer's
kill-and-resume and the launcher; the factored AdamW, the LM batches, a
train, prefill and decode step of each reduced LM, the GNN serve step and
the LM launchers; all on the CPU.

The train steps take the reference's batches, initial parameters and
optimizer state, carried across; float32 sums differ in order between the
two, so loss, grad_norm and parameters agree within rtol 1e-4, atol 1e-6.
A resumed port run repeats an unbroken one exactly.
"""
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (Shape, get_arch, list_archs,
                                      make_step, param_builders)
from repro_torch.configs.reduced import reduce_arch
from repro_torch.data.pipeline import gnn_batch, make_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import fake_process_group, make_mesh
from repro_torch.models.gnn.common import graph_batch_from_numpy
from repro_torch.models.gnn.gcn import (gcn_params_from_numpy,
                                        opt_state_from_numpy)
from repro_torch.models.params import params_from_numpy
from repro_torch.optim.adamw import (OptConfig, adamw_update,
                                     clip_by_global_norm, global_norm,
                                     init_opt_state)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.trainer import Trainer, TrainerConfig


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    mod = importlib.import_module
    return SimpleNamespace(
        jax=mod("jax"), jnp=mod("jax.numpy"), base=mod("repro.configs.base"),
        reduced=mod("repro.configs.reduced"),
        adamw=mod("repro.optim.adamw"), data=mod("repro.data.pipeline"))


def close(got: torch.Tensor, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-6, err_msg=msg)


def random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"layers": [{"b": rng.standard_normal(5).astype(np.float32),
                        "w": rng.standard_normal((7, 5)).astype(np.float32)},
                       {"b": rng.standard_normal(3).astype(np.float32),
                        "w": rng.standard_normal((5, 3)).astype(np.float32)}]}


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_and_adamw_match_reference(ref, max_norm):
    """Three AdamW steps on random trees, with weight decay and clipping
    (active at 0.5, idle at 100), against the reference's functions."""
    cfg_j = ref.adamw.OptConfig(lr=1e-2, weight_decay=0.1)
    cfg = OptConfig(lr=1e-2, weight_decay=0.1)
    p_j = ref.jax.tree.map(ref.jnp.asarray, random_tree(0))
    st_j = ref.adamw.init_opt_state(p_j, cfg_j)
    p = gcn_params_from_numpy(random_tree(0), "cpu")
    st = init_opt_state(p, cfg)
    assert st["step"].dtype == torch.int32 and set(st["per_param"]) == set(p)
    for k in range(3):
        g_tree = random_tree(10 + k)
        g_j, n_j = ref.adamw.clip_by_global_norm(
            ref.jax.tree.map(ref.jnp.asarray, g_tree), max_norm)
        g, n = clip_by_global_norm(gcn_params_from_numpy(g_tree, "cpu"),
                                   max_norm)
        close(n, n_j)
        close(global_norm(g), ref.adamw.global_norm(g_j))
        p_j, st_j = ref.adamw.adamw_update(p_j, g_j, st_j, cfg_j)
        p, st = adamw_update(p, g, st, cfg)
    want = gcn_params_from_numpy(ref.jax.device_get(p_j), "cpu")
    want_st = opt_state_from_numpy(ref.jax.device_get(st_j), "cpu")
    assert int(st["step"]) == int(want_st["step"]) == 3
    for name in want:
        close(p[name], want[name], name)
        for moment in ("m", "v"):
            close(st["per_param"][name][moment],
                  want_st["per_param"][name][moment], f"{name}.{moment}")


def test_train_steps_match_reference(ref):
    """Three steps of the reduced gcn-cora at full_graph_sm: the port's
    make_step against the reference's, on the reference's batches, from its
    initial parameters and optimizer state."""
    arch_j = ref.reduced.reduce_arch("gcn-cora")
    shape_j = arch_j.shape("full_graph_sm")
    arch = reduce_arch("gcn-cora")
    shape = arch.shape("full_graph_sm")
    assert shape.dims == shape_j.dims and arch.opt.lr == arch_j.opt.lr
    init_j, _ = ref.base.param_builders(arch_j, shape_j)
    p_j, _ = init_j(ref.jax.random.PRNGKey(0))
    st_j = ref.adamw.init_opt_state(p_j, arch_j.opt)
    p = gcn_params_from_numpy(ref.jax.device_get(p_j), "cpu")
    st = opt_state_from_numpy(ref.jax.device_get(st_j), "cpu")
    step_j = ref.jax.jit(ref.base.make_step(arch_j, shape_j))
    step = make_step(arch, shape)
    for k in range(3):
        b_j = ref.data.gnn_batch(arch_j, shape_j, k, seed=0)
        p_j, st_j, m_j = step_j(p_j, st_j, b_j)
        p, st, m = step(p, st, graph_batch_from_numpy(b_j, "cpu"))
        close(m["loss"], m_j["loss"], f"loss, step {k}")
        close(m["grad_norm"], m_j["grad_norm"], f"grad_norm, step {k}")
    want = gcn_params_from_numpy(ref.jax.device_get(p_j), "cpu")
    for name in want:
        close(p[name], want[name], name)


def test_kill_and_resume_is_exact(tmp_path):
    """Six steps in one run equal three, a 'node failure', a restore and
    three more, bit for bit (the data stream is step-keyed)."""
    arch = reduce_arch("gcn-cora")
    a = Trainer(arch, "full_graph_sm", device="cpu", cfg=TrainerConfig(
        steps=6, ckpt_every=100, log_every=1, ckpt_dir=str(tmp_path / "a")))
    log_a = a.run()
    b1 = Trainer(arch, "full_graph_sm", device="cpu", cfg=TrainerConfig(
        steps=3, ckpt_every=3, log_every=1, ckpt_dir=str(tmp_path / "b")))
    b1.run()
    del b1
    b2 = Trainer(arch, "full_graph_sm", device="cpu", cfg=TrainerConfig(
        steps=6, ckpt_every=100, log_every=1, ckpt_dir=str(tmp_path / "b")))
    assert b2.maybe_restore() == 3
    log_b = b2.run()
    assert [m["step"] for m in log_b] == [4, 5, 6]
    assert log_a[-1]["loss"] == log_b[-1]["loss"]
    assert log_a[-1]["grad_norm"] == log_b[-1]["grad_norm"]
    for name in a.params:
        assert torch.equal(a.params[name], b2.params[name])


def test_checkpoint_falls_back_past_a_corrupt_file(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
             "opt": {"step": torch.tensor(2, dtype=torch.int32)}}
    mgr.save(2, state)
    later = {"params": {"w": state["params"]["w"] + 1},
             "opt": {"step": torch.tensor(4, dtype=torch.int32)}}
    path = mgr.save(4, later)
    manifest = json.loads(path.with_suffix(".json").read_text())
    assert manifest["file"] == path.name and len(manifest["sha256"]) == 64
    like = {"params": {"w": torch.zeros(2, 3)},
            "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    got, step = mgr.restore(like)
    assert step == 4 and torch.equal(got["params"]["w"], later["params"]["w"])
    path.write_bytes(b"torn")
    got, step = mgr.restore(like)
    assert step == 2 and mgr.latest_step() == 2
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert got["opt"]["step"].dtype == torch.int32
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"params": {"w": torch.zeros(3, 2)},
                     "opt": {"step": torch.zeros((), dtype=torch.int32)}})


def test_launcher_runs_reduced_on_cpu(tmp_path, capsys):
    log = launch_train.main(["--arch", "gcn-cora", "--reduced", "--steps", "2",
                             "--device", "cpu", "--ckpt-dir",
                             str(tmp_path)])
    assert [m["step"] for m in log] == [2]
    assert np.isfinite(log[-1]["loss"]) and log[-1]["grad_norm"] > 0
    assert "step     2" in capsys.readouterr().out
    assert CheckpointManager(tmp_path).latest_step() == 2
    # --model-parallel 2 trains under a 2-rank group (test_torch_sharded.py
    # runs it so); one rank without a group cannot split
    with pytest.raises(ValueError, match="torchrun"):
        launch_train.main(["--arch", "gcn-cora", "--reduced",
                           "--model-parallel", "2", "--device", "cpu"])


def test_registry_and_unported_paths_raise():
    assert list_archs() == ["dien", "egnn", "gcn-cora", "gin-tu",
                            "granite-moe-1b-a400m", "llama3-405b", "mace",
                            "phi4-mini-3.8b", "qwen1.5-32b",
                            "qwen3-moe-30b-a3b"]
    arch = get_arch("gcn-cora")
    assert arch.model_cfg.n_layers == 2 and arch.model_cfg.d_hidden == 16
    shape = arch.shape("ogb_products")
    assert shape.dims["n_nodes"] == 2449029
    init_fn, _ = param_builders(arch, shape)
    params = init_fn(torch.Generator().manual_seed(0))
    assert params["layers.0.w"].shape == (100, 16)
    assert params["layers.1.w"].shape == (16, 47)
    gin = get_arch("gin-tu")
    assert gin.model_cfg.n_layers == 5 and gin.model_cfg.d_hidden == 64
    params = param_builders(gin, shape)[0](torch.Generator().manual_seed(0))
    assert params["mlps.0.0.w"].shape == (100, 64)
    assert params["heads.4.w"].shape == (64, 47)
    assert get_arch("mace").model_cfg.dtype == "bfloat16"
    assert get_arch("egnn").model_cfg.n_layers == 4
    dien = get_arch("dien")
    assert dien.microbatches == 8 and dien.opt.accum_dtype == "float32"
    assert [s.kind for s in dien.shapes] == ["train", "serve", "serve",
                                             "retrieval"]
    b = gnn_batch(reduce_arch("gcn-cora"), reduce_arch("gcn-cora").shape(
        "molecule"), 3, seed=1, device="cpu")
    assert b.n_graphs == 4 and b.feats.shape == (40, 8)
    # the paths that raised until the LMs were ported (ROADMAP A10 (d),
    # (e)), one check each
    lm = reduce_arch("phi4-mini-3.8b")
    p_lm = param_builders(lm)[0](torch.Generator().manual_seed(0))
    assert p_lm["layers.attn.wq.w"].shape == (2, 64, 64)
    assert p_lm["embed"].shape == (512, 64)
    small = reduce_arch("gcn-cora")
    serve = Shape("s", "serve", small.shape("full_graph_sm").dims)
    metrics = make_step(small, serve)(
        param_builders(small, serve)[0](torch.Generator().manual_seed(0)),
        gnn_batch(small, serve, 0, device="cpu"))
    assert set(metrics) == {"xent"} and bool(torch.isfinite(metrics["xent"]))
    logits, cache = make_step(lm, lm.shape("prefill_32k"))(
        p_lm, make_batch(lm, lm.shape("prefill_32k"), 0, device="cpu"))
    assert logits.shape == (2, 512) and cache[0].shape == (2, 2, 128, 2, 16)
    b_lm = make_batch(lm, lm.shapes[0], 0, device="cpu")
    assert b_lm["tokens"].shape == (8, 64)
    assert torch.equal(b_lm["tokens"], b_lm["labels"])
    st = init_opt_state({"w": torch.zeros(2, 3)}, OptConfig(factored=True))
    assert {k: tuple(v.shape) for k, v in st["per_param"]["w"].items()} \
        == {"m": (2, 3), "vr": (2,), "vc": (3,)}
    # the paths that raised until the sharded step was ported (ROADMAP A9
    # (d)): remesh onto one device carries the state over exactly, and a
    # mesh of two devices (a fake group here; gloo ranks in
    # test_torch_sharded.py) holds each rank's shards
    tr = Trainer(reduce_arch("gcn-cora"), "full_graph_sm", device="cpu")
    tr.run_step()
    before = {k: v.clone() for k, v in tr.params.items()}
    tr.remesh(None)
    assert tr.step == 1 and not tr.sharded
    assert all(torch.equal(tr.params[k], v) for k, v in before.items())
    assert tr.run_step()["loss"].isfinite()
    with fake_process_group(2):
        tr = Trainer(arch, "full_graph_sm", device="cpu",
                     mesh=make_mesh((2, 1), ("data", "model")))
        assert tr.sharded and tr._sharded.local_bytes == sum(
            t.numel() * t.element_size() for t in tr.params.values()) + sum(
            t.numel() * t.element_size() for st in
            tr.opt_state["per_param"].values() for t in st.values()) + 4


# ------------------------------------------------------------------- LMs

LM_ARCHS = ("phi4-mini-3.8b", "qwen1.5-32b", "llama3-405b",
            "granite-moe-1b-a400m", "qwen3-moe-30b-a3b")


def scaled(got, want, tol, msg=""):
    """|got - want| within tol of want's largest magnitude."""
    err = float((got.double() - want.double()).abs().max())
    assert err <= tol * max(float(want.double().abs().max()), 1e-30), (
        msg, err)


def numpy_tree(seed, shapes):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


# a stacked [L, d] norm scale (factored, as the reference factors it), a
# stacked weight, a vector and a [1, d] row (neither factored)
FACTOR_SHAPES = {"scale": (3, 16), "w": (3, 16, 8), "b": (5,),
                 "row": (1, 4)}


@pytest.mark.parametrize("b1,mdt", [(0.0, "bfloat16"), (0.9, "float32")])
def test_factored_adamw_matches_reference(ref, b1, mdt):
    """Three factored AdamW steps (llama3-405b's optimizer: b1 0, bfloat16
    moments; and b1 0.9, float32 moments) against the reference's update:
    parameters within rtol 1e-4, atol 1e-6, the row and column statistics
    within rtol 1e-4 (float32) or 1e-2 (bfloat16)."""
    kw = dict(lr=1e-2, b1=b1, moment_dtype=mdt, factored=True)
    cfg_j, cfg = ref.adamw.OptConfig(**kw), OptConfig(**kw)
    p_j = {k: ref.jnp.asarray(v) for k, v in
           numpy_tree(0, FACTOR_SHAPES).items()}
    st_j = ref.adamw.init_opt_state(p_j, cfg_j)
    p = {k: torch.from_numpy(v) for k, v in
         numpy_tree(0, FACTOR_SHAPES).items()}
    st = init_opt_state(p, cfg)
    want_keys = {k: set(v) for k, v in st_j["per_param"].items()}
    assert {k: set(v) for k, v in st["per_param"].items()} == want_keys
    assert want_keys["scale"] >= {"vr", "vc"} and "v" in want_keys["row"]
    assert ("m" in want_keys["w"]) == (b1 > 0)
    for k in range(3):
        g = numpy_tree(10 + k, FACTOR_SHAPES)
        p_j, st_j = ref.adamw.adamw_update(
            p_j, {n: ref.jnp.asarray(v) for n, v in g.items()}, st_j, cfg_j)
        p, st = adamw_update(p, {n: torch.from_numpy(v)
                                 for n, v in g.items()}, st, cfg)
    want_st = opt_state_from_numpy(ref.jax.device_get(st_j), "cpu")
    assert int(st["step"]) == 3
    for name in p:
        close(p[name], np.asarray(p_j[name]), name)
        for moment, got in st["per_param"][name].items():
            want = want_st["per_param"][name][moment]
            assert got.dtype == want.dtype == getattr(torch, mdt)
            np.testing.assert_allclose(
                got.float().numpy(), want.float().numpy(),
                rtol=1e-4 if mdt == "float32" else 1e-2, atol=1e-12,
                err_msg=f"{name}.{moment}")


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_batch_matches_reference(ref, arch_id):
    arch_j, arch = ref.reduced.reduce_arch(arch_id), reduce_arch(arch_id)
    for shape_id, step, seed in (("train_4k", 0, 0), ("train_4k", 3, 1),
                                 ("prefill_32k", 1, 2)):
        want = ref.data.lm_batch(arch_j, arch_j.shape(shape_id), step, seed)
        got = make_batch(arch, arch.shape(shape_id), step, seed,
                         device="cpu")
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_steps_match_reference(ref, arch_id):
    """One make_step train step of the reduced LM (2 microbatches) from the
    reference's initial parameters and optimizer state on its batch:
    loss, grad_norm, parameters and optimizer state against the
    reference's (parameters rtol 1e-4, atol 1e-6, atol 3e-5 where the
    gradients accumulate in bfloat16; the moments within 1e-4 of their
    largest magnitude, bfloat16 ones 1e-2); then its prefill and decode
    steps from the reference's stepped parameters (each decode step from
    the reference's cache before it): logits within 1e-5 of their largest
    magnitude, the cache written (``cache_close``)."""
    jax, jnp = ref.jax, ref.jnp
    arch_j, arch = ref.reduced.reduce_arch(arch_id), reduce_arch(arch_id)
    tr_j, tr = arch_j.shape("train_4k"), arch.shape("train_4k")
    pf_j, pf = arch_j.shape("prefill_32k"), arch.shape("prefill_32k")
    dc_j, dc = arch_j.shape("decode_32k"), arch.shape("decode_32k")
    init_j, _ = ref.base.param_builders(arch_j, tr_j)
    p_j, _ = init_j(jax.random.PRNGKey(0))
    st_j = ref.adamw.init_opt_state(p_j, arch_j.opt)
    p = params_from_numpy(jax.device_get(p_j), "cpu")
    st = opt_state_from_numpy(jax.device_get(st_j), "cpu")
    b_j = ref.data.lm_batch(arch_j, tr_j, 0, 0)
    pre_toks = ref.data.lm_batch(arch_j, pf_j, 0, 0)["tokens"][:, :16]
    new = jnp.asarray([[3], [5]], jnp.int32)
    train_j = ref.base.make_step(arch_j, tr_j)
    prefill_j = ref.base.make_step(arch_j, pf_j)
    decode_j = ref.base.make_step(arch_j, dc_j)

    def steps(p, st, b, toks, new):
        p, st, m = train_j(p, st, b)
        logits, cache = prefill_j(p, {"tokens": toks})
        cache = tuple(jnp.pad(c, ((0, 0), (0, 0), (0, 2), (0, 0), (0, 0)))
                      for c in cache)
        out = [logits]
        for i in range(2):
            logits, cache = decode_j(p, {
                "token": new + i, "cache_k": cache[0], "cache_v": cache[1],
                "cache_len": jnp.int32(16 + i)})
            out.append(logits)
        return p, st, m, out, cache
    p_j, st_j, m_j, logits_j, cache_j = jax.device_get(
        jax.jit(steps)(p_j, st_j, b_j, pre_toks, new))

    p, st, m = make_step(arch, tr)(p, st, {k: torch.tensor(np.asarray(v))
                                           for k, v in b_j.items()})
    close(m["loss"], m_j["loss"], "loss")
    close(m["grad_norm"], m_j["grad_norm"], "grad_norm")
    want_p = params_from_numpy(p_j, "cpu")
    want_st = opt_state_from_numpy(st_j, "cpu")
    assert set(p) == set(want_p)
    # llama3's gradients accumulate in bfloat16: an element may round to
    # the neighbouring bfloat16 value (2**-8 relative) in the other package,
    # and its update moves with it
    atol = 3e-2 * arch.opt.lr if arch.opt.accum_dtype == "bfloat16" else 1e-6
    for name in want_p:
        # Adam's first update is lr * g / (|g| + eps): where |g| is within
        # the two packages' float32 noise of 0 (below 1e-6), it may take
        # any value in [-lr, lr] in either; elsewhere rtol 1e-4, atol 1e-6
        sure = np.ones(tuple(p[name].shape), bool)
        if "m" in want_st["per_param"][name]:
            g = want_st["per_param"][name]["m"].double().numpy() / (
                1 - arch.opt.b1)
            sure = np.abs(g) > 1e-6
        got_p, want = p[name].numpy(), want_p[name].numpy()
        np.testing.assert_allclose(got_p[sure], want[sure], rtol=1e-4,
                                   atol=atol, err_msg=name)
        assert np.all(np.abs(got_p - want)[~sure] <= 2 * arch.opt.lr), name
        for moment, want in want_st["per_param"][name].items():
            got = st["per_param"][name][moment]
            assert got.dtype == want.dtype
            scaled(got, want, 1e-4 if got.dtype == torch.float32 else 1e-2,
                   f"{name}.{moment}")
    # the serve steps from the reference's stepped parameters; each decode
    # step from the reference's cache as it stood before that step
    cfg, p = arch.model_cfg, want_p
    ref_cache = [params_from_numpy({"c": c}, "cpu")["c"] for c in cache_j]
    logits, cache = make_step(arch, pf)(
        p, {"tokens": torch.tensor(np.asarray(pre_toks))})
    scaled(logits, torch.tensor(np.asarray(logits_j[0])), 1e-5,
           "prefill")
    for got, want in zip(cache, ref_cache):
        assert got.dtype == cfg.cache_dtype
        cache_close(got, want[:, :, :16])
    for i in range(2):
        before = [c.clone() for c in ref_cache]
        for c in before:
            c[:, :, 16 + i:] = 0
        logits, after = make_step(arch, dc)(p, {
            "token": torch.tensor(np.asarray(new)) + i,
            "cache_k": before[0], "cache_v": before[1],
            "cache_len": torch.tensor(16 + i, dtype=torch.int32)})
        assert not logits.requires_grad and after[0] is before[0]
        scaled(logits, torch.tensor(np.asarray(logits_j[i + 1])), 1e-5,
               f"decode {i}")
        for got, want in zip(after, ref_cache):
            cache_close(got[:, :, 16 + i], want[:, :, 16 + i])


def cache_close(got, want):
    """float8: the same bytes but where a value rounds to the adjacent
    float8 value (its float32 input differs in the last bits between the
    packages), for under 1 % of them; else within rtol 1e-4, atol 1e-5."""
    if got.dtype != torch.float8_e4m3fn:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)
        return
    g = got.view(torch.uint8).numpy().astype(int)
    w = want.view(torch.uint8).numpy().astype(int)
    assert np.all(np.abs(g - w) <= 1) and np.all((g ^ w) & 0x80 == 0)
    assert (g != w).mean() < 1e-2, (g != w).mean()


def test_gnn_serve_step_matches_reference(ref):
    """The GNN forward-only serve step: the loss's metrics, against the
    reference's make_step on its batch and parameters."""
    arch_j = ref.reduced.reduce_arch("gin-tu")
    arch = reduce_arch("gin-tu")
    dims = arch.shape("molecule").dims
    shape_j = ref.base.Shape("serve", "serve", dims)
    shape = Shape("serve", "serve", dims)
    p_j, _ = ref.base.param_builders(arch_j, shape_j)[0](
        ref.jax.random.PRNGKey(0))
    b_j = ref.data.gnn_batch(arch_j, shape_j, 0, seed=0)
    want = ref.base.make_step(arch_j, shape_j)(p_j, b_j)
    got = make_step(arch, shape)(params_from_numpy(
        ref.jax.device_get(p_j), "cpu"), graph_batch_from_numpy(b_j, "cpu"))
    assert set(got) == set(want) and not got["xent"].requires_grad
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5)


def test_lm_kill_and_resume_is_exact(tmp_path):
    """The reduced qwen3-moe (MoE dispatch, 2 microbatches): four steps in
    one run equal two, a restore and two more, bit for bit."""
    arch = reduce_arch("qwen3-moe-30b-a3b")
    a = Trainer(arch, "train_4k", device="cpu", cfg=TrainerConfig(
        steps=4, ckpt_every=100, log_every=1, ckpt_dir=str(tmp_path / "a")))
    log_a = a.run()
    Trainer(arch, "train_4k", device="cpu", cfg=TrainerConfig(
        steps=2, ckpt_every=2, log_every=1,
        ckpt_dir=str(tmp_path / "b"))).run()
    b2 = Trainer(arch, "train_4k", device="cpu", cfg=TrainerConfig(
        steps=4, ckpt_every=100, log_every=1, ckpt_dir=str(tmp_path / "b")))
    assert b2.maybe_restore() == 2
    log_b = b2.run()
    assert [m["step"] for m in log_b] == [3, 4]
    assert log_a[-1] | {"wall": 0} == log_b[-1] | {"wall": 0}
    for name in a.params:
        assert torch.equal(a.params[name], b2.params[name]), name


def test_checkpoint_carries_bfloat16_and_float8(tmp_path):
    """bfloat16 moments (llama3-405b's optimizer) and float8 tensors go
    through a checkpoint bit for bit."""
    mgr = CheckpointManager(tmp_path)
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    state = {"m": x.to(torch.bfloat16), "c": x.to(torch.float8_e4m3fn),
             "w": x}
    mgr.save(1, state)
    got, step = mgr.restore({k: torch.zeros_like(v)
                             for k, v in state.items()})
    assert step == 1
    for k, v in state.items():
        assert got[k].dtype == v.dtype
        assert torch.equal(got[k].view(torch.uint8), v.view(torch.uint8))


def test_lm_launchers_on_cpu(tmp_path, capsys):
    """launch.train on a reduced LM, and launch.serve's CLI with
    --prompt-len and --new-tokens."""
    log = launch_train.main(["--arch", "llama3-405b", "--reduced", "--steps",
                             "2", "--device", "cpu", "--ckpt-dir",
                             str(tmp_path)])
    assert [m["step"] for m in log] == [2]
    assert np.isfinite(log[-1]["loss"]) and log[-1]["grad_norm"] > 0
    assert CheckpointManager(tmp_path).latest_step() == 2
    toks = launch_serve.main(["--arch", "phi4-mini-3.8b", "--reduced",
                              "--requests", "3", "--prompt-len", "10",
                              "--new-tokens", "4", "--device", "cpu"])
    assert toks.shape == (3, 4) and toks.dtype == torch.int32
    assert bool(((toks >= 0) & (toks < 512)).all())
    assert "served 3 requests x 4 tokens" in capsys.readouterr().out
    again = launch_serve.main(["--arch", "phi4-mini-3.8b", "--reduced",
                               "--requests", "3", "--prompt-len", "10",
                               "--new-tokens", "4", "--device", "cpu"])
    assert torch.equal(toks, again)
