"""The port's DIEN against the JAX package's, on the reduced ``dien`` arch:
the batches, the loss and its gradients, the train step with one and with
two microbatches, the serve step and the retrieval step; then the serving
launcher and the Trainer on the CPU.

The batches are the reference's bits (``_fold`` hashes a tuple of ints,
which every process hashes alike). Parameters and optimizer state are
carried across by name. The float32 sums run in other orders: loss and
serve probabilities within rtol 1e-5; gradients, train-step losses, grad
norms and parameters within rtol 1e-4, atol 1e-6 (as GCN's), except the
attention MLP's gradients: they are near 1e-9, what is left of the
softmax's cancelling terms, and agree only to about 1e-3 of themselves, so
each is held within 1e-2 of its own largest magnitude; the last bias's is
zero but for rounding (the softmax does not see a shift of every score),
so it is held below 1e-2 of the last weight's largest; retrieval scores
within 1e-5 of the largest, and the top-100 ids equal wherever the
neighbouring scores differ by more than that.
"""
import dataclasses
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.base import make_step
from repro_torch.configs.reduced import reduce_arch
from repro_torch.data.pipeline import recsys_batch
from repro_torch.launch import serve as launch_serve
from repro_torch.models.params import opt_state_from_numpy, params_from_numpy
from repro_torch.models.recsys import dien as DT
from repro_torch.train.trainer import Trainer, TrainerConfig

TOL = 1e-5
ATT_TOL = 1e-2  # attention-MLP gradients, of their own largest magnitude


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    mod = importlib.import_module
    r = SimpleNamespace(
        jax=mod("jax"), jnp=mod("jax.numpy"), base=mod("repro.configs.base"),
        reduced=mod("repro.configs.reduced"), data=mod("repro.data.pipeline"),
        adamw=mod("repro.optim.adamw"), dien=mod("repro.models.recsys.dien"))
    r.arch = r.reduced.reduce_arch("dien")
    shape = r.arch.shape("train_batch")
    r.params = r.base.param_builders(r.arch, shape)[0](
        r.jax.random.PRNGKey(0))[0]
    return r


def port_params(ref):
    return params_from_numpy(ref.jax.device_get(ref.params), "cpu")


def batches(ref, shape_id, step=0, seed=0):
    want = ref.data.recsys_batch(ref.arch, ref.arch.shape(shape_id), step,
                                 seed)
    arch = reduce_arch("dien")
    return want, recsys_batch(arch, arch.shape(shape_id), step, seed,
                              device="cpu")


def near(got, want, tol=TOL, msg=""):
    want = torch.from_numpy(np.array(want, np.float64))
    err = float((got.detach().to(torch.float64) - want).abs().max())
    assert err <= tol * max(float(want.abs().max()), 1e-12), (msg, err)


def close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-6, err_msg=msg)


@pytest.mark.parametrize("shape_id", ["train_batch", "serve_p99",
                                      "serve_bulk", "retrieval_cand"])
@pytest.mark.parametrize("step,seed", [(0, 0), (3, 5)])
def test_batches_are_bit_equal(ref, shape_id, step, seed):
    want, got = batches(ref, shape_id, step, seed)
    assert set(got) == set(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert v.numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(v.numpy(), w, k)
    if shape_id == "train_batch":
        assert got["labels"].dtype == torch.float32


def test_loss_and_grads_match_reference(ref):
    arch = reduce_arch("dien")
    cfg, cfg_j = arch.model_cfg, ref.arch.model_cfg
    want_b, b = batches(ref, "train_batch", 2)
    (loss_j, aux_j), g_j = ref.jax.jit(ref.jax.value_and_grad(
        lambda p, bb: ref.dien.dien_loss(p, bb, cfg_j), has_aux=True))(
        ref.params, want_b)
    p = {k: v.requires_grad_(True) for k, v in port_params(ref).items()}
    loss, aux = DT.dien_loss(p, b, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=TOL)
    for k in ("bce", "aux"):
        np.testing.assert_allclose(float(aux[k].detach()), float(aux_j[k]),
                                   rtol=TOL)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    want = params_from_numpy(ref.jax.device_get(g_j), "cpu")
    assert set(grads) == set(want) and "gru.wx" in grads
    for name, g in grads.items():
        if name == "att.1.b":
            scale = float(want["att.1.w"].abs().max())
            assert float(g.abs().max()) <= ATT_TOL * scale, name
        elif name.startswith("att."):
            near(g, want[name], ATT_TOL, name)
        else:
            close(g, want[name], name)


@pytest.mark.parametrize("k", [1, 2])
def test_train_steps_match_reference(ref, k):
    """Two train steps with k microbatches: the port's make_step against
    the reference's, from its parameters and optimizer state."""
    arch_j = dataclasses.replace(ref.arch, microbatches=k)
    arch = dataclasses.replace(reduce_arch("dien"), microbatches=k)
    shape_j, shape = arch_j.shape("train_batch"), arch.shape("train_batch")
    st_j = ref.adamw.init_opt_state(ref.params, arch_j.opt)
    p, st = port_params(ref), opt_state_from_numpy(
        ref.jax.device_get(st_j), "cpu")
    step_j = ref.jax.jit(ref.base.make_step(arch_j, shape_j))
    step = make_step(arch, shape)
    p_j = ref.params
    for i in range(2):
        b_j, b = batches(ref, "train_batch", i)
        p_j, st_j, m_j = step_j(p_j, st_j, b_j)
        p, st, m = step(p, st, b)
        assert set(m) == set(m_j), (set(m), set(m_j))
        close(m["loss"], m_j["loss"], f"loss, step {i}")
        close(m["grad_norm"], m_j["grad_norm"], f"grad_norm, step {i}")
    want = params_from_numpy(ref.jax.device_get(p_j), "cpu")
    for name in want:
        close(p[name], want[name], name)


def test_serve_and_retrieval_match_reference(ref):
    arch = reduce_arch("dien")
    p = port_params(ref)
    for shape_id in ("serve_p99", "serve_bulk"):
        want_b, b = batches(ref, shape_id, 1)
        want = ref.jax.jit(ref.base.make_step(
            ref.arch, ref.arch.shape(shape_id)))(ref.params, want_b)
        got = make_step(arch, arch.shape(shape_id))(p, b)
        assert got.shape == (arch.shape(shape_id).dims["batch"],)
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL)
    want_b, b = batches(ref, "retrieval_cand", 1)
    scores_j, top_j = ref.jax.jit(lambda pp, bb: ref.dien.dien_retrieval(
        pp, bb, ref.arch.model_cfg))(ref.params, want_b)
    scores, top = DT.dien_retrieval(p, b, arch.model_cfg)
    near(scores, scores_j, msg="scores")
    step_top = make_step(arch, arch.shape("retrieval_cand"))(p, b)
    assert torch.equal(step_top, top) and top.shape == (2, 100)
    s_j, top_j = np.asarray(scores_j, np.float64), np.asarray(top_j)
    tol = TOL * np.abs(s_j).max()
    for row in range(top.shape[0]):
        ranked = np.sort(s_j[row])[::-1][:101]
        gaps = np.abs(np.diff(ranked))
        for i in range(100):
            if gaps[i] > tol and (i == 0 or gaps[i - 1] > tol):
                assert int(top[row, i]) == int(top_j[row, i]), (row, i)
        assert np.all(np.diff(scores[row, top[row]].numpy()) <= 0)


def test_serve_launcher_and_trainer_on_cpu(capsys):
    probs = launch_serve.main(["--arch", "dien", "--reduced", "--requests",
                               "8", "--device", "cpu"])
    assert probs.shape == (8,) and bool(((probs > 0) & (probs < 1)).all())
    assert "scored 8 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no serving path"):
        launch_serve.main(["--arch", "gin-tu", "--reduced", "--device",
                           "cpu"])
    # the LM half of the same launcher serves a reduced LM on the CPU
    toks = launch_serve.serve_lm(reduce_arch("granite-moe-1b-a400m"), 2, 8,
                                 3, device="cpu")
    assert toks.shape == (2, 3) and toks.dtype == torch.int32
    assert "served 2 requests x 3 tokens" in capsys.readouterr().out
    tr = Trainer(reduce_arch("dien"), "train_batch", device="cpu",
                 cfg=TrainerConfig(steps=2, log_every=1))
    log = tr.run()
    assert [m["step"] for m in log] == [1, 2]
    assert set(log[0]) == {"loss", "grad_norm", "step", "wall"}
    assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in log)
