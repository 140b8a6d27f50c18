"""The port's training path against the JAX package's: the AdamW update and
gradient clipping, three train steps of the reduced gcn-cora, the Trainer's
kill-and-resume and the launcher, all on the CPU.

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

from repro_torch.configs.base import (Arch, Shape, get_arch, list_archs,
                                      make_step, param_builders)
from repro_torch.configs.reduced import reduce_arch
from repro_torch.data.pipeline import gnn_batch, make_batch
from repro_torch.launch import train as launch_train
from repro_torch.models.gnn.common import graph_batch_from_numpy
from repro_torch.models.gnn.gcn import (gcn_params_from_numpy,
                                        opt_state_from_numpy)
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
    with pytest.raises(NotImplementedError, match="A9"):
        launch_train.main(["--arch", "gcn-cora", "--reduced",
                           "--model-parallel", "2", "--device", "cpu"])


def test_registry_and_unported_paths_raise():
    assert list_archs() == ["dien", "egnn", "gcn-cora", "gin-tu", "mace"]
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
    lm = Arch("lm", "lm-dense", None, (Shape("t", "train", {}),))
    with pytest.raises(NotImplementedError, match="A10"):
        param_builders(lm)
    with pytest.raises(NotImplementedError, match="A10"):
        make_step(arch, Shape("s", "serve", {}))
    with pytest.raises(NotImplementedError, match="A10"):
        make_step(dien, Shape("p", "prefill", {}))
    with pytest.raises(NotImplementedError, match="A10"):
        make_batch(lm, lm.shapes[0], 0, device="cpu")
    with pytest.raises(NotImplementedError, match="A10"):
        init_opt_state({"w": torch.zeros(2, 2)}, OptConfig(factored=True))
    tr = Trainer(reduce_arch("gcn-cora"), "full_graph_sm", device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        tr.remesh(None)
    with pytest.raises(NotImplementedError, match="A9"):
        Trainer(arch, "full_graph_sm", device="cpu",
                mesh=SimpleNamespace(size=2))
