"""The port's FLOP estimates, roofline terms and counting mode
(``launch/flops.py``, ``launch/roofline.py``) against the reference's.

``analytic_flops`` must equal the reference's exactly for every cell. The
ring formulas must give the bytes the reference's HLO parser finds for
the all-gather and the 32-trip all-reduce of
``tests/test_roofline_parser.py``'s module, and the dominance test of
``roofline_terms`` holds on the H100 constants. The counting mode is
checked on single ops (a product's 2mnk FLOPs, a view's zero bytes, a
slice write's slice bytes, peak live bytes, a kernel wrapper on meta
tensors as one read and one write) and on the dry-run's layer rule: an LM
counted at 1 and 2 layers gives, exactly, what a trace at 3 layers counts.
"""
import dataclasses

import pytest
import torch
from test_roofline_parser import HLO

from repro.configs import base as jbase
from repro.launch.flops import analytic_flops as janalytic
from repro.launch.roofline import parse_collectives
from repro_torch.configs import base as tbase
from repro_torch.configs.reduced import reduce_arch
from repro_torch.kernels.bottom_up_probe.ops import bottom_up_probe
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as rl
from repro_torch.launch.dryrun import _count, counted_step
from repro_torch.launch.flops import analytic_flops


@pytest.mark.parametrize("arch_id", tbase.list_archs())
def test_analytic_flops_equal_reference(arch_id):
    arch, jarch = tbase.get_arch(arch_id), jbase.get_arch(arch_id)
    for shape in arch.shapes:
        got = analytic_flops(arch, shape)
        want = janalytic(jarch, jarch.shape(shape.shape_id))
        assert got == want, shape.shape_id
        assert type(got["model_flops"]) is type(want["model_flops"])


def test_wire_formulas_match_reference_parser():
    stats = parse_collectives(HLO, n_devices=256)
    r = 128 * 256 * 4
    assert rl.wire_bytes("all-gather", r, 16) \
        == stats.by_op["all-gather"]["wire_bytes"]
    assert 32 * rl.wire_bytes("all-reduce", r, 16) \
        == stats.by_op["all-reduce"]["wire_bytes"]
    assert rl.wire_bytes("reduce-scatter", r, 16) == r * 15
    assert rl.wire_bytes("all-to-all", r, 16) == r * 15 / 16
    assert rl.wire_bytes("collective-permute", r, 16) == r
    with pytest.raises(ValueError):
        rl.wire_bytes("broadcast", r, 16)


def test_roofline_terms_dominance_h100():
    t = rl.roofline_terms(rl.PEAK_FLOPS, rl.HBM_BW * 2,
                          rl.INTER_NODE_BW * 0.5)
    assert t["dominant"] == "memory"
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["collective_s"] - 0.5) < 1e-9
    assert abs(t["roofline_fraction"] - 0.5) < 1e-9
    t = rl.roofline_terms(0.0, 0.0, 1.0, collective_s=3.0)
    assert t["dominant"] == "collective" and t["step_time_bound_s"] == 3.0


def test_h100_constants_only():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.NVLINK_BW, rl.INTER_NODE_BW) \
        == (989e12, 3.35e12, 450e9, 50e9)
    values = {v for v in vars(rl).values() if isinstance(v, float)}
    assert not values & {197e12, 819e9}          # the TPU v5e's
    assert not hasattr(rl, "ICI_BW")
    assert rl.group_link_bw(range(8)) == rl.NVLINK_BW
    assert rl.group_link_bw(range(8, 16)) == rl.NVLINK_BW
    assert rl.group_link_bw(range(16)) == rl.INTER_NODE_BW
    assert rl.group_link_bw(range(0, 256, 16)) == rl.INTER_NODE_BW


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("inference", [False, True])
def test_counting_matmul(inference):
    m, k, n = 64, 48, 16
    a, b = meta(m, k), meta(k, n)
    with torch.inference_mode(inference), rl.CountingMode() as cm:
        a @ b
        torch.einsum("ik,kj->ij", a, b)
    assert cm.flops == 2 * (2 * m * n * k)
    assert cm.hbm_bytes == 2 * 4 * (m * k + k * n + m * n)


def test_counting_views_and_slice_writes():
    x, y = meta(10, 100), meta(10, 20)
    with rl.CountingMode() as cm:
        x.view(100, 10)[2:5].reshape(-1)
        x.t()[3]
    assert cm.hbm_bytes == 0 and cm.flops == 0
    with rl.CountingMode() as cm:
        x.t()[2:5].reshape(-1)                    # not a view: a copy
    assert cm.hbm_bytes == 2 * 3 * 10 * 4
    with rl.CountingMode() as cm:
        x[:, 20:40] = y
    assert cm.hbm_bytes == 2 * 10 * 20 * 4        # read y, write the slice
    with rl.CountingMode() as cm:
        x.add_(1.0)
    assert cm.hbm_bytes == 10 * 100 * 4           # the tensor it mutates
    with rl.CountingMode() as cm:
        x + 1.0
    assert cm.hbm_bytes == 2 * 10 * 100 * 4


def test_counting_peak_live_bytes():
    x = meta(1000)
    with rl.CountingMode() as cm:
        cm.hold(x)
        y = x * 2
        z = y + 1
        del y
        w = z.sin()
        v = w[:10]
    assert cm.peak_bytes == 3 * 4000               # x, z, then w in y's place
    assert cm.live_bytes == 3 * 4000 and v.is_meta
    del z, w, v
    assert cm.live_bytes == 4000


def test_counting_data_dependent_ops_raise():
    x = meta(8)
    with pytest.raises(rl.DataDependentOp, match="_local_scalar_dense"):
        with rl.CountingMode():
            int(x.sum())
    with pytest.raises(rl.DataDependentOp, match="nonzero"):
        with rl.CountingMode():
            torch.nonzero(x)


def test_kernel_wrapper_counts_as_its_kernel():
    n, m, nw = 1024, 8192, 32
    rp, ci = meta(n + 1, dtype=torch.int32), meta(m, dtype=torch.int32)
    fw = meta(nw, dtype=torch.int32)
    unv, par = meta(n, dtype=torch.bool), meta(n, dtype=torch.int32)
    with rl.CountingMode() as cm:
        found, parent = bottom_up_probe(rp, ci, fw, unv, par, 8)
    assert found.is_meta and found.dtype == torch.bool and parent.shape == (n,)
    kernel = 4 * (n + 1 + m + nw + n) + n + 2 * 4 * n   # inputs + 2 outputs
    assert cm.hbm_bytes == kernel + 4 * n + n     # + the wrapper's != 0
    assert cm.ops == 2


@pytest.mark.parametrize("arch_id", ["phi4-mini-3.8b", "qwen3-moe-30b-a3b"])
def test_layer_rule_is_exact(arch_id):
    """At 3 layers, the dry-run's count from 1 and 2 layers equals a trace
    of all 3, for a train, a prefill and a decode step."""
    red = reduce_arch(arch_id)
    arch = dataclasses.replace(
        red, model_cfg=dataclasses.replace(red.model_cfg, n_layers=3))
    for shape in arch.shapes:
        got = counted_step(arch, shape)
        want = _count(arch, shape)
        assert got["counted_rule"].startswith("traced at 1 and 2 layers")
        assert got["counted_flops_global"] == want["flops"] > 0, shape
        assert got["counted_hbm_bytes_global"] == want["hbm_bytes"], shape
        assert got["counted_ops"] == want["ops"], shape


def test_counted_step_gnn_names_its_host_value(monkeypatch):
    """The GNN steps read no value (a fixed-size adjacency, the kernels'
    meta ops, counted with their FLOP rules); a step that does is named."""
    arch = reduce_arch("gcn-cora")
    got = counted_step(arch, arch.shapes[0])
    assert got["counted_flops_global"] > 0
    kernels = got["counted_kernel_flops"]
    assert set(kernels) == {"ell_spmm", "spmm_residue"}
    assert kernels["ell_spmm"]["rule"].startswith("2 * n * k_max * d")
    assert kernels["spmm_residue"]["rule"].startswith("2 * m * d")
    monkeypatch.setattr(dryrun, "make_step", lambda arch, shape: (
        lambda *args: torch.nonzero(torch.empty(4, device="meta"))))
    got = counted_step(arch, arch.shapes[0])
    assert got["counted_flops_global"] is None
    assert "nonzero" in got["counted_skip_reason"]
    monkeypatch.undo()
    arch = reduce_arch("egnn")
    got = counted_step(arch, arch.shapes[0])
    assert got["counted_flops_global"] > 0
    assert got["counted_rule"] == "traced whole"
