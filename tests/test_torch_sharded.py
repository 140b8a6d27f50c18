"""The sharded train step (``train/sharded.py``) and multi-device training
against the JAX package's unsharded step.

The reference's own sharded ``Trainer`` does not run in this container (a
``scan`` over sharded inputs, a gather without ``out_sharding`` and
``owner_gather_scatter``'s scatter outside a mesh all raise; ROADMAP queue
C), and under GSPMD its sharded step computes the unsharded one's function,
so the yardstick is the reference's unsharded step. For the reduced
``gcn-cora``, ``gin-tu``, ``phi4-mini-3.8b``, ``granite-moe-1b-a400m``,
``dien`` and ``llama3-405b`` (factored AdamW: its row and column means
reduced over the ranks that split them), two steps from the reference's initial parameters on its batches
(seed 0) run in three places: the reference's jitted ``make_step`` in this
process, and on four gloo ranks (``run_ranks``) the port's sharded step on
a 2x2 ("data", "model") mesh and, on rank 0, the port's unsharded step.
Losses and grad norms agree within rtol 1e-4, the first step's parameters
and the last step's moments as ``_close_steps`` sets out. Each rank holds exactly its ``LeafSharding``s'
bytes of parameters and optimizer state.

On the same ranks: ``constrain`` under ``use_mesh`` against
``resolve_spec``'s placements; a reduced MoE whose routing groups are cut
in token chunks within rows, sharded against unsharded; ``Trainer.remesh``
from 2x2 to a 1x2 mesh over ranks 0-1 (the reference's ``ELASTIC_CODE``:
two steps, remesh, one step, against a fresh 1x2 run of three, and the
state bit-equal across the remesh); a checkpoint written on 2x2 restored on
a 1x2 mesh there and on one device here, bit for bit. On two gloo ranks,
``launch.train.main(["--model-parallel", "2", ...])``. Here:
``make_batch(host_id=, n_hosts=4)`` against the reference's, and the
reference's straggler permutation check.
"""
import dataclasses
import importlib
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs.reduced import reduce_arch
from repro_torch.data.pipeline import make_batch
from repro_torch.distributed.ranks import run_ranks

NDEV = 4
# llama3-405b's factored AdamW takes its means over the ranks that split them
CASES = (("gcn-cora", "full_graph_sm"), ("gin-tu", "full_graph_sm"),
         ("phi4-mini-3.8b", "train_4k"),
         ("granite-moe-1b-a400m", "train_4k"), ("dien", "train_batch"),
         ("llama3-405b", "train_4k"))
STEPS = 2
RTOL = 1e-4


def _port_batch(arch, batch):
    from repro_torch.models.gnn.common import graph_batch_from_numpy
    if arch.family == "gnn":
        return graph_batch_from_numpy(batch, "cpu")
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_np(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _run_case(arch, shape, mesh, params, batches, unsharded: bool):
    """Steps of the sharded step from ``params`` (whole, numpy names) on
    ``batches``; rank 0 also runs the unsharded step."""
    import torch.distributed as dist

    from repro_torch.configs.base import make_step
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train.sharded import make_sharded_step
    p = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    st = init_opt_state(p, arch.opt)
    step = make_sharded_step(arch, shape, mesh)
    lp, lst = step.place(p, st)
    assert _nbytes(lp) + _nbytes(lst) == step.local_bytes
    assert step.local_bytes < _nbytes(p) + _nbytes(st)
    out = dict(sharded=[], unsharded=[])
    for b in batches:
        lp, lst, m = step(lp, lst, step.shard_batch(_port_batch(arch, b)))
        assert step.mode == "split"
        out["sharded"].append(({k: float(v) for k, v in m.items()},
                               _np(step.gather(lp, lst))))
    if unsharded and dist.get_rank() == 0:
        plain = make_step(arch, shape)
        for b in batches:
            p, st, m = plain(p, st, _port_batch(arch, b))
            out["unsharded"].append(({k: float(v) for k, v in m.items()},
                                     _np((p, st))))
    return out


def _constrain_checks(mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed.sharding import (constrain, leaf_sharding,
                                                  use_mesh)
    x = torch.arange(32.0).reshape(8, 4)
    assert constrain(x, ("batch", None)) is x
    d = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    with use_mesh(mesh):
        got = constrain(d, ("batch", "heads"))
        assert constrain(x, ("batch", None)) is x
    assert got.placements == leaf_sharding(x, ("batch", "heads"),
                                           mesh).placements
    assert torch.equal(got.full_tensor(), x)
    assert constrain(d, ("batch", None)) is d


def _chunked_moe(mesh):
    """A reduced granite whose 4-row microbatches route in chunks of 32
    tokens (half a row): sharded against unsharded."""
    arch = reduce_arch("granite-moe-1b-a400m")
    cfg = arch.model_cfg
    arch = dataclasses.replace(arch, model_cfg=dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, token_chunk=32)))
    shape = arch.shape("train_4k")
    from repro_torch.configs.base import param_builders
    params = param_builders(arch, shape)[0](torch.Generator().manual_seed(3))
    batches = [make_batch(arch, shape, k, device="cpu") for k in range(2)]
    return _run_case(arch, shape, mesh, _np(params),
                     [{k: v.numpy() for k, v in b.items()} for b in batches],
                     unsharded=True)


def _elastic(mesh, sub, ckpt_dir):
    """The reference's ELASTIC_CODE on gcn-cora: 2 steps on 2x2, remesh to
    1x2 over ranks 0-1, 1 step; a fresh 1x2 run of 3 steps; then a
    checkpoint of a 2x2 run restored on the 1x2 mesh."""
    import torch.distributed as dist

    from repro_torch.train.trainer import Trainer, TrainerConfig
    arch = reduce_arch("gcn-cora")
    tr = Trainer(arch, "full_graph_sm", mesh=mesh, device="cpu",
                 cfg=TrainerConfig(steps=4, log_every=1))
    tr.run(2)
    before = tr.full_state()
    tr.remesh(sub)
    after = tr.full_state()
    out = {"on_sub": tr.on_mesh}
    if after is not None:
        out["kept"] = all(torch.equal(before[0][k], after[0][k])
                          for k in before[0]) and all(
            torch.equal(a, b) for a, b in zip(_leaves(before[1]),
                                              _leaves(after[1])))
    m = tr.run_step()
    fresh = Trainer(arch, "full_graph_sm", mesh=sub, device="cpu",
                    cfg=TrainerConfig(steps=4, log_every=1))
    fresh.run(2)
    m2 = fresh.run_step()
    if m is not None:
        out["elastic"], out["fresh"] = float(m["loss"]), float(m2["loss"])
    # a checkpoint written on 2x2 ...
    lm = reduce_arch("phi4-mini-3.8b")
    tr = Trainer(lm, "train_4k", mesh=mesh, device="cpu",
                 cfg=TrainerConfig(steps=2, ckpt_dir=ckpt_dir))
    tr.run()
    saved = tr.full_state()
    # ... restored on the 1x2 mesh
    back = Trainer(lm, "train_4k", mesh=sub, device="cpu",
                   cfg=TrainerConfig(steps=2, ckpt_dir=ckpt_dir))
    if back.on_mesh:
        assert back.maybe_restore() == 2
        got = back.full_state()
        out["restored_1x2"] = all(
            torch.equal(a, b) for a, b in zip(_leaves(saved), _leaves(got)))
    if dist.get_rank() == 0:
        out["saved"] = _np(saved[0]), _np(saved[1])
    return out


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def sharded_rank(inputs, ckpt_dir):
    """A gloo rank: the reference-input cases, the constrain checks, the
    token-chunked MoE, the remesh and the checkpoint."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"))
    sub = DeviceMesh("cpu", [[0, 1]], mesh_dim_names=("data", "model"))
    out = {}
    for (arch_id, shape_id), (params, batches) in inputs.items():
        arch = reduce_arch(arch_id)
        out[arch_id] = _run_case(arch, arch.shape(shape_id), mesh, params,
                                 batches, unsharded=True)
    _constrain_checks(mesh)
    out["chunked_moe"] = _chunked_moe(mesh)
    out["elastic"] = _elastic(mesh, sub, ckpt_dir)
    every = [None] * NDEV
    dist.all_gather_object(every, {"elastic": {
        k: v for k, v in out["elastic"].items() if k != "saved"}})
    out["every"] = every
    return out


def launcher_rank(ckpt_dir):
    """A gloo rank of two: the training launcher with --model-parallel 2."""
    from repro_torch.launch import train as launch_train
    torch.set_num_threads(1)
    return launch_train.main(["--arch", "gcn-cora", "--reduced", "--steps",
                              "2", "--model-parallel", "2", "--device",
                              "cpu", "--ckpt-dir", ckpt_dir])


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    mod = importlib.import_module
    return SimpleNamespace(
        jax=mod("jax"), base=mod("repro.configs.base"),
        reduced=mod("repro.configs.reduced"),
        adamw=mod("repro.optim.adamw"), data=mod("repro.data.pipeline"))


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """The reference's inputs; then the gloo launches in threads while the
    reference steps in this process."""
    from repro_torch.models.params import (opt_state_from_numpy,
                                           params_from_numpy)
    jax = ref.jax
    inputs, want = {}, {}
    for arch_id, shape_id in CASES:
        arch_j = ref.reduced.reduce_arch(arch_id)
        shape_j = arch_j.shape(shape_id)
        p_j, _ = ref.base.param_builders(arch_j, shape_j)[0](
            jax.random.PRNGKey(0))
        batches = [jax.device_get(ref.data.make_batch(arch_j, shape_j, k,
                                                      seed=0))
                   for k in range(STEPS)]
        flat = {k: v.numpy() for k, v in params_from_numpy(
            jax.device_get(p_j), "cpu").items()}
        inputs[arch_id, shape_id] = (flat, batches)
        want[arch_id] = (arch_j, shape_j, p_j, batches)
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    launch_dir = str(tmp_path_factory.mktemp("launch"))
    out = {}

    def launch(name, *args):
        try:
            out[name] = run_ranks(*args, device="cpu")
        except Exception as e:  # reported by the tests that read it
            out[name] = e

    threads = [threading.Thread(target=launch, args=(
                   "sharded", sharded_rank, NDEV, inputs, ckpt)),
               threading.Thread(target=launch, args=(
                   "launcher", launcher_rank, 2, launch_dir))]
    for t in threads:
        t.start()
    refs = {}
    for arch_id, (arch_j, shape_j, p_j, batches) in want.items():
        step = jax.jit(ref.base.make_step(arch_j, shape_j))
        st = ref.adamw.init_opt_state(p_j, arch_j.opt)
        steps = []
        for b in batches:
            p_j, st, m = step(p_j, st, b)
            steps.append(({k: float(v) for k, v in m.items()},
                          _np((params_from_numpy(jax.device_get(p_j), "cpu"),
                               opt_state_from_numpy(jax.device_get(st),
                                                    "cpu")))))
        refs[arch_id] = steps
    for t in threads:
        t.join()
    for name in ("sharded", "launcher"):
        if isinstance(out[name], Exception):
            raise out[name]
    return SimpleNamespace(ref=refs, port=out["sharded"],
                           launcher=out["launcher"], ckpt=ckpt,
                           launch_dir=launch_dir)


def _close_metrics(got, want, msg):
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=1e-6,
                                   err_msg=f"{msg} {k}")


def scaled(got, want, tol, msg, floor=0.0):
    """Within ``tol`` of ``want``'s largest magnitude, or ``floor``."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(g - w), initial=0.0))
    assert err <= max(tol * float(np.max(np.abs(w), initial=0.0)), floor), (
        msg, err)


def _close_steps(got, want, arch, msg):
    """``got`` and ``want``: per step (metrics, (params, optimizer state)),
    whole tensors. Every step's loss and grad norm within rtol 1e-4; the
    first step's parameters within rtol 1e-4, atol 1e-6 (3e-2 lr where the
    gradients accumulate in bfloat16) where the gradient is clear of
    float32 noise (|g| over 1e-6; elsewhere Adam's first update
    lr * g / (|g| + eps) takes any value in [-lr, lr], as
    ``test_torch_train.py`` has it); the last step's moments, sums of the
    gradients, within 1e-4 of their largest magnitude (1e-2 in bfloat16)
    or 1e-10 (the
    moments of a gradient that is float32 noise around 0, as a bias the
    softmax cancels has); and every parameter
    within 2 lr a step (a later Adam update turns float32 noise in a small
    or cancelling gradient into a visible share of lr)."""
    for k, ((m_got, _), (m_want, _)) in enumerate(zip(got, want)):
        _close_metrics(m_got, m_want, f"{msg} step {k}")
    (p1, st1), (p1_w, st1_w) = got[0][1], want[0][1]
    # llama3's gradients accumulate in bfloat16: an element may round to
    # the neighbouring value (2**-8 relative), and its update with it (as
    # test_torch_train.py allows)
    atol = 3e-2 * arch.opt.lr if arch.opt.accum_dtype == "bfloat16" else 1e-6
    for name, w in p1_w.items():
        sure = np.ones(w.shape, bool)
        if "m" in st1_w["per_param"][name]:
            sure = np.abs(st1_w["per_param"][name]["m"].astype(np.float64)
                          / (1 - arch.opt.b1)) > 1e-6
        np.testing.assert_allclose(p1[name][sure], w[sure], rtol=RTOL,
                                   atol=atol, err_msg=f"{msg} {name}")
    (p, st), (p_w, st_w) = got[-1][1], want[-1][1]
    steps = len(want)
    # bfloat16 moments (llama3's): one rounding step of 2**-8 apart where
    # their float32 values straddle it, as test_torch_train.py allows
    tol = 1e-2 if arch.opt.moment_dtype == "bfloat16" else RTOL
    for name, w in p_w.items():
        assert np.all(np.abs(p[name] - w) <= 2 * steps * arch.opt.lr), name
        for mom, mw in st_w["per_param"][name].items():
            scaled(st["per_param"][name][mom], mw, tol,
                   f"{msg} {name}.{mom}", floor=1e-10)


@pytest.mark.parametrize("arch_id", [a for a, _ in CASES])
def test_sharded_step_matches_reference(runs, arch_id):
    """Two sharded steps on 2x2 against the reference's unsharded steps;
    the port's unsharded steps against the reference's too."""
    port, arch = runs.port[arch_id], reduce_arch(arch_id)
    want = runs.ref[arch_id]
    _close_steps(port["sharded"], want, arch, "sharded")
    _close_steps(port["unsharded"], want, arch, "unsharded")


def test_token_chunked_moe_sharded_matches_unsharded(runs):
    """Routing groups cut in chunks within rows: capacity, drops and aux
    losses are the unsharded step's."""
    out = runs.port["chunked_moe"]
    _close_steps(out["sharded"], out["unsharded"],
                 reduce_arch("granite-moe-1b-a400m"), "chunked")


def test_remesh_preserves_training(runs):
    """2 steps on 2x2, remesh to 1x2 over ranks 0-1, 1 step: within 1e-4
    of a fresh 1x2 run of 3 steps; the state bit-equal across the remesh;
    ranks 2-3 hold nothing after it."""
    every = [e["elastic"] for e in runs.port["every"]]
    for r, e in enumerate(every):
        assert e["on_sub"] == (r < 2)
        if r < 2:
            assert e["kept"]
            assert abs(e["elastic"] - e["fresh"]) < 1e-4, e
        else:
            assert "elastic" not in e


def test_checkpoint_restores_across_meshes(runs):
    """A checkpoint written on 2x2 restores bit for bit on the 1x2 mesh
    and on one device."""
    from repro_torch.train.trainer import Trainer, TrainerConfig
    every = [e["elastic"] for e in runs.port["every"]]
    assert all(every[r]["restored_1x2"] for r in range(2))
    saved_p, saved_opt = runs.port["elastic"]["saved"]
    tr = Trainer(reduce_arch("phi4-mini-3.8b"), "train_4k", device="cpu",
                 cfg=TrainerConfig(steps=2, ckpt_dir=runs.ckpt))
    assert tr.maybe_restore() == 2
    for k, v in saved_p.items():
        assert tr.params[k].numpy().tobytes() == v.tobytes(), k
    got = list(_leaves(_np(tr.opt_state)))
    want = list(_leaves(saved_opt))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


def test_launcher_model_parallel(runs):
    """--model-parallel 2 under a 2-rank gloo group trains on a 1x2 mesh
    and writes its checkpoint."""
    from repro_torch.train.checkpoint import CheckpointManager
    log = runs.launcher
    assert [m["step"] for m in log] == [2]
    assert np.isfinite(log[-1]["loss"]) and log[-1]["grad_norm"] > 0
    assert CheckpointManager(runs.launch_dir).latest_step() == 2


@pytest.mark.parametrize("arch_id", ["dien", "phi4-mini-3.8b"])
def test_host_batches_match_reference(ref, arch_id):
    """Each of four hosts' batch equals the reference's bit for bit."""
    arch_j = ref.reduced.reduce_arch(arch_id)
    arch = reduce_arch(arch_id)
    shape_j, shape = arch_j.shapes[0], arch.shapes[0]
    for h in range(4):
        want = ref.data.make_batch(arch_j, shape_j, 7, seed=0, host_id=h,
                                   n_hosts=4)
        got = make_batch(arch, shape, 7, seed=0, device="cpu", host_id=h,
                         n_hosts=4)
        assert set(got) == set(want)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].shape[0] * 4 == (shape.dims.get("batch")
                                           or shape.dims["global_batch"])
            assert got[k].numpy().dtype == w.dtype
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_straggler_rebalance_batch_permutation():
    """The reference's check: permuting the host-to-slice assignment keeps
    the global batch."""
    arch = reduce_arch("dien")
    shape = arch.shape("train_batch")
    parts = [make_batch(arch, shape, 7, seed=0, device="cpu", host_id=h,
                        n_hosts=4) for h in range(4)]
    full = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    perm = [2, 0, 3, 1]
    full_p = {k: torch.cat([parts[i][k] for i in perm]) for k in parts[0]}
    assert sorted(full["target_item"].tolist()) \
        == sorted(full_p["target_item"].tolist())
    assert not torch.equal(full["target_item"], full_p["target_item"])

