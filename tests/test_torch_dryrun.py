"""The port's dry-runs (``launch/bfs_dryrun.py``, ``launch/dryrun.py``)
against the reference's formulas and record keys.

Every dry-run starts a fake process group, so each runs in a child process
(no test worker keeps a default group). A small ``bfs_cell`` on a 4x4 fake
mesh must give per-layer wire bytes equal to the ring formula on the
port's own exchanges: the counts all-reduce of 12 bytes, ``_topdown``'s
all-reduce MIN of 4n bytes, ``_bottomup``'s all-gather of the n/8-byte
bitmap, and the final all-gathers of parent and depth; its shapes are the
reference's analytic ones. A reduced config's ``dryrun_cell`` writes the
reference's record keys, its analytic FLOPs and its per-device argument
bytes (the sum of the reference's shard shapes), and traces the sharded
step: ``status: "ok"`` with every memory, collective and roofline term.
The reduced phi4-mini's sharded train step on a fake 2x2 group counts the
all-gather and reduce-scatter wire bytes reckoned by hand from its
``LeafSharding``s and its attention's key/value chunks. The two CLIs write
their records under the reference's file names. The module starts all its
children together, in threads, on first use.
"""
import json
import math
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from conftest import SRC, run_in_subprocess
from repro.configs import base as jbase
from repro.configs.reduced import reduce_arch as jreduce
from repro.distributed.sharding import resolve_spec as jresolve
from repro.launch.flops import analytic_flops as janalytic
from repro_torch.benchmarks import roofline as roofline_bench
from test_torch_shapes import flat_leaves

# the reference's record keys (src/repro/launch/bfs_dryrun.py,
# src/repro/launch/dryrun.py) that the port writes too
BFS_KEYS = {"kind", "scale", "edgefactor", "mesh", "n_devices", "n",
            "m_loc", "status", "flops_per_device", "hbm_bytes_per_device",
            "collective", "memory", "roofline"}
BFS_COLLECTIVE_KEYS = {"wire_bytes_per_device", "per_layer_wire_bytes",
                       "num_collectives", "by_op"}
MEMORY_KEYS = {"argument_bytes", "temp_bytes", "output_bytes"}
CELL_KEYS = {"arch", "shape", "mesh", "kind", "status", "n_devices",
             "model_flops_global", "executed_flops_global", "memory",
             "roofline"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant",
                 "step_time_bound_s", "roofline_fraction"}
COLLECTIVE_KEYS = {"wire_bytes_per_device", "num_collectives", "by_op"}


BFS_CELL = """
    import json
    from repro_torch.launch.bfs_dryrun import bfs_cell
    from repro_torch.launch.mesh import fake_process_group, make_mesh
    with fake_process_group(16):
        rec = bfs_cell(12, 8, False, mesh=make_mesh((4, 4), ("data", "model")))
    print(json.dumps(rec))
"""
REDUCED_CELLS = """
    import json
    from repro_torch.configs.base import register
    from repro_torch.configs.reduced import reduce_arch
    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.launch.mesh import fake_process_group
    arch = register(reduce_arch("{arch_id}"))
    recs = []
    for mp, world in ((False, 256), (True, 512)):
        with fake_process_group(world):
            recs += [dryrun_cell(arch.arch_id, s.shape_id, mp)
                     for s in arch.shapes]
    print(json.dumps(recs))
"""
LM_2X2 = """
    import json
    from repro_torch.configs.reduced import reduce_arch
    from repro_torch.launch.dryrun import sharded_terms
    from repro_torch.launch.mesh import fake_process_group, make_mesh
    arch = reduce_arch("phi4-mini-3.8b")
    with fake_process_group(4):
        t = sharded_terms(arch, arch.shape("train_4k"),
                          make_mesh((2, 2), ("data", "model")))
    print(json.dumps(t))
"""
REDUCED_ARCHS = ("phi4-mini-3.8b", "qwen3-moe-30b-a3b", "dien")
CLI_RUNS = {
    "bfs": ("bfs_dryrun", ["--scale", "12", "--edgefactor", "4"]),
    "mace": ("dryrun", ["--arch", "mace", "--both-meshes"]),
    "long": ("dryrun", ["--arch", "llama3-405b", "--shape", "long_500k"]),
    "gcn": ("dryrun", ["--arch", "gcn-cora", "--shape", "full_graph_sm",
                       "--multi-pod", "--no-donate"]),
}


def cli(module, argv, out):
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", *argv,
         "--out", str(out)], capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": SRC, "PATH": "/usr/bin:/bin"})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every child of the module, started together: ({name: its stdout
    or completed process}, the CLIs' output directory)."""
    out = tmp_path_factory.mktemp("dryrun")
    with ThreadPoolExecutor(len(REDUCED_ARCHS) + len(CLI_RUNS) + 2) as ex:
        futs = {"bfs_cell": ex.submit(run_in_subprocess,
                                      textwrap.dedent(BFS_CELL)),
                "lm_2x2": ex.submit(run_in_subprocess,
                                    textwrap.dedent(LM_2X2))}
        for a in REDUCED_ARCHS:
            futs[a] = ex.submit(run_in_subprocess, textwrap.dedent(
                REDUCED_CELLS.format(arch_id=a)))
        for name, (module, argv) in CLI_RUNS.items():
            futs[name] = ex.submit(cli, module, argv, out / name)
        yield {k: f.result() for k, f in futs.items()}, out


def ring(op, r, k):
    return {"all-reduce": 2 * r * (k - 1) / k,
            "all-gather": r * (k - 1) / k}[op]


def test_bfs_cell_wire_bytes_are_the_ring_formula(runs):
    scale, ef, k = 12, 8, 16
    rec = json.loads(runs[0]["bfs_cell"])
    assert BFS_KEYS <= set(rec) and rec["status"] == "ok"
    assert BFS_COLLECTIVE_KEYS <= set(rec["collective"])
    assert MEMORY_KEYS <= set(rec["memory"])
    assert ROOFLINE_KEYS <= set(rec["roofline"])
    # the reference's analytic shapes (bfs_dryrun.py:30-35)
    block = -(-(1 << scale) // (k * 32)) * 32
    n = block * k
    m_loc = int(np.ceil((1 << scale) * ef * 2 / k * 1.5))
    assert (rec["n_devices"], rec["n"], rec["m_loc"], rec["mesh"]) \
        == (k, n, m_loc, "pod4x4")
    assert rec["memory"]["argument_bytes"] \
        == 4 * (block + 1 + 2 * m_loc + block) + 4
    per = rec["per_layer"]
    counts = ring("all-reduce", 12, k)
    want = {"counts": {"all-reduce": counts},
            "topdown": {"all-reduce": ring("all-reduce", 4 * n, k)},
            "bottomup": {"all-gather": ring("all-gather", n // 8, k)},
            "final": {"all-gather": 2 * ring("all-gather", 4 * n, k)}}
    for part, ops in want.items():
        assert {op: d["wire_bytes"] for op, d in per[part]["by_op"].items()} \
            == ops, part
        # one group of 16 consecutive ranks spans two 8-GPU nodes
        assert math.isclose(per[part]["collective_s"],
                            sum(ops.values()) / 50e9)
    by_dir = rec["collective"]["per_layer_wire_bytes_by_direction"]
    td = counts + want["topdown"]["all-reduce"]
    bu = counts + want["bottomup"]["all-gather"]
    assert by_dir == {"topdown": td, "bottomup": bu}
    assert rec["collective"]["per_layer_wire_bytes"] == max(td, bu)
    assert rec["collective"]["wire_bytes_per_device"] \
        == 64 * max(td, bu) + want["final"]["all-gather"]
    assert rec["loop_bound"]["max_layers"] == 64
    assert rec["roofline"]["dominant"] in ("memory", "collective")
    assert rec["memory"]["peak_live_bytes"] >= 4 * n   # the top-down buffer


def test_bfs_dryrun_cli(runs):
    out = runs[0]["bfs"]
    assert out.returncode == 0, out.stderr
    for mesh, ndev in (("pod16x16", 256), ("pod2x16x16", 512)):
        rec = json.loads((runs[1] / "bfs" / f"bfs-graph500__scale12_ef4__"
                          f"{mesh}.json").read_text())
        assert rec["status"] == "ok" and rec["n_devices"] == ndev
        assert rec["collective"]["per_layer_wire_bytes"] > 0
        assert f"[ok] bfs-graph500__scale12_ef4__{mesh}" in out.stdout


def ref_arg_bytes(jarch, shape_id, mesh_shape, names):
    """Bytes one device holds of the reference's step arguments, from its
    resolver's shard shapes."""
    amesh = AbstractMesh(mesh_shape, names)
    args, specs = jbase.step_arg_specs(jarch, jarch.shape(shape_id))
    total = 0
    for _, x, spec in flat_leaves(args, specs):
        local = NamedSharding(amesh, jresolve(tuple(x.shape), spec, amesh)
                              ).shard_shape(tuple(x.shape))
        total += int(np.prod(local)) * np.dtype(x.dtype).itemsize
    return total


@pytest.mark.parametrize("arch_id", REDUCED_ARCHS)
def test_dryrun_cell_reduced(runs, arch_id):
    recs = json.loads(runs[0][arch_id])
    jarch = jreduce(arch_id)
    assert len(recs) == 2 * len(jarch.shapes)
    for rec in recs:
        assert CELL_KEYS <= set(rec), rec
        assert MEMORY_KEYS <= set(rec["memory"])
        assert ROOFLINE_KEYS <= set(rec["roofline"])
        assert rec["status"] == "ok", rec.get("skip_reason")
        assert all(v is not None for v in rec["memory"].values()), rec
        assert all(v is not None for v in rec["roofline"].values()), rec
        assert COLLECTIVE_KEYS <= set(rec["collective"])
        assert rec["collective"]["num_collectives"] > 0
        assert rec["hbm_bytes_per_device"] > 0
        assert rec["memory"]["temp_bytes"] > 0
        shape = jarch.shape(rec["shape"])
        an = janalytic(jarch, shape)
        assert rec["model_flops_global"] == an["model_flops"]
        assert rec["executed_flops_global"] == an["executed_flops"]
        mesh = ((16, 16), ("data", "model")) if rec["mesh"] == "pod16x16" \
            else ((2, 16, 16), ("pod", "data", "model"))
        assert rec["n_devices"] == math.prod(mesh[0])
        assert rec["memory"]["argument_bytes"] \
            == ref_arg_bytes(jarch, rec["shape"], *mesh)
        assert rec["roofline"]["compute_s"] == pytest.approx(
            max(an["executed_flops"] / rec["n_devices"],
                rec["flops_per_device"]) / 989e12, rel=1e-12)
        assert rec["counted_flops_global"] > 0
        if shape.kind == "train":
            assert 0 < rec["memory"]["alias_bytes"] \
                < rec["memory"]["argument_bytes"]
        elif shape.kind in ("serve", "retrieval", "prefill"):
            assert rec["memory"]["alias_bytes"] == 0


def test_dryrun_cli(runs):
    recs = {}
    for name in ("mace", "long", "gcn"):
        assert runs[0][name].returncode == 0, runs[0][name].stderr
        recs.update({f.stem: json.loads(f.read_text())
                     for f in (runs[1] / name).glob("*.json")})
    assert len(recs) == 10
    for mesh in ("pod16x16", "pod2x16x16"):
        for shape in ("full_graph_sm", "minibatch_lg", "ogb_products",
                      "molecule"):
            rec = recs[f"mace__{shape}__{mesh}"]
            assert rec["status"] == "ok" and rec["sharded"]["mode"] == "split"
            assert rec["counted_flops_global"] > 0
            assert rec["collective"]["by_op"]["reduce-scatter"]["count"] > 0
    long = recs["llama3-405b__long_500k__pod16x16"]
    assert long["status"] == "skipped"
    assert long["skip_reason"] == jbase.get_arch("llama3-405b").shape(
        "long_500k").skip_reason
    gcn = recs["gcn-cora__full_graph_sm__pod2x16x16"]
    assert gcn["status"] == "ok" and gcn["sharded"]["mode"] == "split"
    assert gcn["counted_flops_global"] > 0
    assert 0.25 <= gcn["model_to_counted_ratio"] <= 2
    assert set(gcn["counted_kernel_flops"]) == {"ell_spmm", "spmm_residue"}
    assert None not in gcn["memory"].values()
    assert None not in gcn["roofline"].values()
    assert gcn["collective"]["num_collectives"] > 0
    assert gcn["memory"]["alias_bytes"] == 0 and not gcn["donate"]


def test_roofline_tables(runs):
    """``benchmarks/roofline.py`` renders the CLIs' records: a row a model
    cell of the mesh, the reference-skipped shape as skipped, a row a BFS
    cell."""
    rows = roofline_bench.markdown_table("pod16x16", runs[1] / "mace")
    rows = rows.splitlines()[2:]
    assert len(rows) == 4 and all(r.startswith("| mace |") for r in rows)
    assert not any("skipped" in r or "—" in r for r in rows)
    long = roofline_bench.markdown_table("pod16x16", runs[1] / "long")
    assert long.splitlines()[2].startswith("| llama3-405b | long_500k |")
    bfs = roofline_bench.bfs_table("pod2x16x16", runs[1] / "bfs")
    (row,) = bfs.splitlines()[2:]
    assert row.startswith("| 12 | 4 |") and row.endswith(" |")
    assert roofline_bench.device_gb({"memory": {
        "argument_bytes": 3e9, "temp_bytes": 2e9, "output_bytes": None,
        "alias_bytes": 1e9}}) == 4.0


def test_sharded_lm_collectives_by_hand(runs):
    """The reduced phi4-mini's sharded train step on a fake 2x2 group (its
    two microbatches of 4 rows split in 2 rows over "data" and 32 tokens
    over "model"): all-gather and reduce-scatter wire bytes are the ring
    formula over 2 ranks on what the step gathers and scatters. A
    parameter is all-gathered over its sharded axes, the model axis first,
    where it is used: once a microbatch for the embedding, the final norm
    and the head, twice for a layer's (its forward and its recomputation);
    the backward reduce-scatters each gather once. A layer's keys and
    values are all-gathered over "model" in its forward and its
    recomputation and their gradients reduce-scattered once."""
    from repro_torch.configs.base import step_arg_specs
    from repro_torch.configs.reduced import reduce_arch
    from repro_torch.distributed.sharding import tree_shardings
    got = json.loads(runs[0]["lm_2x2"].strip().splitlines()[-1])
    arch = reduce_arch("phi4-mini-3.8b")
    cfg, k = arch.model_cfg, arch.microbatches
    args, specs = step_arg_specs(arch, arch.shape("train_4k"))
    sh = tree_shardings(args, specs, {"data": 2, "model": 2})
    ag = rs = 0.0
    for name, t in args[0].items():
        pl = sh[f"0.{name}"].placements
        shape = list(sh[f"0.{name}"].local_shape)
        uses = 2 if name.startswith("layers.") else 1
        for p in reversed(pl):            # the model axis first
            if p.is_shard():
                before = math.prod(shape) * t.element_size()
                shape[p.dim] *= 2
                ag += k * uses * ring("all-gather", 2 * before, 2)
                rs += k * before          # R (k - 1), R the shard
    rows, chunk = 8 // k // 2, 64 // 2
    kv = rows * chunk * cfg.n_kv_heads * cfg.d_head * 4
    ag += k * cfg.n_layers * 2 * 2 * ring("all-gather", 2 * kv, 2)
    rs += k * cfg.n_layers * 2 * kv
    assert got["mode"] == "split"
    assert got["by_op"]["all-gather"]["wire_bytes"] == pytest.approx(ag)
    assert got["by_op"]["reduce-scatter"]["wire_bytes"] == pytest.approx(rs)
