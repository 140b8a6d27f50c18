"""The port's shape and spec builders (``configs/base.py``: ``param_shapes``,
``input_specs``, ``step_arg_specs``; ``optim/adamw.py::opt_state_specs``)
against the reference's.

For every registered cell the reference does not skip, every leaf of
``step_arg_specs`` (parameters, optimizer state, batch) must carry the
reference's shape, dtype and logical spec, the reference's tree flattened
by the port's dotted names; the five skipped cells keep the reference's
``skip_reason``. The port's arguments are meta tensors: nothing is
allocated, and llama3-405b's 406 B parameters come back within seconds.
The inits' ``device`` argument leaves their draws on the CPU as they were.
"""
import dataclasses
import functools
import time

import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro_torch.configs import base as tbase
from repro_torch.configs.reduced import reduce_arch
from repro_torch.launch.dryrun import dryrun_cell
from repro_torch.optim.adamw import OptConfig, init_opt_state, opt_state_specs

ALL = [(a, s.shape_id) for a in tbase.list_archs()
       for s in tbase.get_arch(a).shapes]
CELLS = [c for c in ALL if not tbase.get_arch(c[0]).shape(c[1]).skip_reason]
SKIPPED = [c for c in ALL if c not in CELLS]
REF_LEAVES = 1968     # the reference's step_arg_specs leaves, all cells


def flat_leaves(shapes, specs, path=()):
    """(dotted path, leaf, spec) of every array of a shapes tree (dicts,
    lists, tuples, a graph batch's array fields), its spec read at the same
    path of ``specs``. The port's flat parameter names hold their dots, so
    both packages' trees flatten to the same paths."""
    if isinstance(shapes, dict):
        items = shapes.items()
    elif isinstance(shapes, (list, tuple)):
        items = enumerate(shapes)
    elif dataclasses.is_dataclass(shapes):
        items = ((f.name, getattr(shapes, f.name))
                 for f in dataclasses.fields(shapes) if f.name != "n_graphs")
    else:
        yield ".".join(map(str, path)), shapes, specs
        return
    for k, v in items:
        sub = (getattr(specs, k) if dataclasses.is_dataclass(specs)
               else specs[k])
        yield from flat_leaves(v, sub, path + (k,))


def dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


@functools.cache
def cell_leaves(arch_id: str, shape_id: str):
    """{path: (shape, dtype, spec)} of each package's ``step_arg_specs``."""
    arch = tbase.get_arch(arch_id)
    args, specs = tbase.step_arg_specs(arch, arch.shape(shape_id))
    port = {p: (tuple(t.shape), dtype_name(t.dtype), s)
            for p, t, s in flat_leaves(args, specs)}
    assert all(t.is_meta for _, t, _ in flat_leaves(args, specs))
    jarch = jbase.get_arch(arch_id)
    jargs, jspecs = jbase.step_arg_specs(jarch, jarch.shape(shape_id))
    ref = {p: (tuple(x.shape), dtype_name(x.dtype),
               None if s is None else tuple(s))
           for p, x, s in flat_leaves(jargs, jspecs)}
    return port, ref


@pytest.mark.parametrize("arch_id,shape_id", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_step_arg_specs_match_reference(arch_id, shape_id):
    port, ref = cell_leaves(arch_id, shape_id)
    assert sorted(port) == sorted(ref)
    for path, want in ref.items():
        assert port[path] == want, path


def test_all_cells_leaf_count():
    assert len(CELLS) == 35 and len(SKIPPED) == 5
    assert sum(len(cell_leaves(*c)[1]) for c in CELLS) == REF_LEAVES
    assert sum(len(cell_leaves(*c)[0]) for c in CELLS) == REF_LEAVES


@pytest.mark.parametrize("arch_id,shape_id", SKIPPED,
                         ids=[f"{a}-{s}" for a, s in SKIPPED])
def test_skipped_cells_keep_reference_reason(arch_id, shape_id):
    want = jbase.get_arch(arch_id).shape(shape_id).skip_reason
    assert want
    assert tbase.get_arch(arch_id).shape(shape_id).skip_reason == want
    rec = dryrun_cell(arch_id, shape_id, multi_pod=False)
    assert rec["status"] == "skipped" and rec["skip_reason"] == want


def test_param_shapes_allocate_nothing():
    arch = tbase.get_arch("llama3-405b")
    t0 = time.perf_counter()
    params, specs = tbase.param_shapes(arch)
    assert time.perf_counter() - t0 < 20
    assert all(p.is_meta for p in params.values())
    assert sorted(params) == sorted(specs)
    assert sum(p.numel() for p in params.values()) \
        == arch.model_cfg.param_count()


def test_pad_matches_reference():
    assert tbase.PAD_MULTIPLE == jbase.PAD_MULTIPLE == 8192
    for n in (1, 8191, 8192, 8193, 2449029, 61859140):
        assert tbase._pad(n) == jbase._pad(n)


@pytest.mark.parametrize("arch_id", ["phi4-mini-3.8b", "qwen1.5-32b",
                                     "qwen3-moe-30b-a3b", "gcn-cora",
                                     "gin-tu", "egnn", "mace", "dien"])
def test_init_device_argument_keeps_draws(arch_id):
    """``device=None`` and the generator's own device draw the same values;
    ``device="meta"`` gives the same names, shapes and dtypes."""
    arch = reduce_arch(arch_id)
    shape = arch.shapes[0]
    cfg = tbase.effective_cfg(arch, shape)
    init = tbase._model(cfg)[0]
    a = init(torch.Generator().manual_seed(3), cfg)
    b = init(torch.Generator().manual_seed(3), cfg, device="cpu")
    m = init(torch.Generator().manual_seed(3), cfg, device="meta")
    assert list(a) == list(b) == list(m)
    for k in a:
        assert torch.equal(a[k], b[k]), k
        assert (m[k].is_meta and m[k].shape == a[k].shape
                and m[k].dtype == a[k].dtype), k


@pytest.mark.parametrize("opt", [OptConfig(),
                                 OptConfig(b1=0.0, factored=True,
                                           moment_dtype="bfloat16")],
                         ids=["adamw", "factored_no_m"])
def test_opt_state_specs_mirror_init_opt_state(opt):
    arch = reduce_arch("llama3-405b")
    params, specs = tbase.param_shapes(arch)
    state = init_opt_state(params, opt)
    ospecs = opt_state_specs(specs, opt, params)
    assert ospecs["step"] is None
    assert state["per_param"].keys() == ospecs["per_param"].keys()
    for name, st in state["per_param"].items():
        assert st.keys() == ospecs["per_param"][name].keys(), name
        for k, t in st.items():
            assert t.is_meta and len(ospecs["per_param"][name][k]) == t.dim()
    if opt.factored:
        sp = specs["layers.attn.wq.w"]
        got = ospecs["per_param"]["layers.attn.wq.w"]
        assert got == {"vr": sp[:-1], "vc": sp[:-2] + sp[-1:]}
