"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points run on the GPU or raise; they never move to the CPU on
their own."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.csr import (from_edges, from_numpy_graph,
                                  from_numpy_weighted_graph,
                                  from_weighted_edges)
from repro_torch.graph.generator import (rmat_graph, rmat_weighted_graph,
                                         uniform_random_graph,
                                         uniform_random_weighted_graph)
from repro_torch.graph.graph500 import run_graph500
from repro_torch.benchmarks import (analytics_bench, dist2d_teps,
                                    dist_msbfs_teps, dist_sssp_teps,
                                    fig3_teps, sssp_teps, table2_switching,
                                    table3_maxpos, table4_counters)
from repro_torch.configs.reduced import reduce_arch
from repro_torch.data.pipeline import gnn_batch, recsys_batch
from repro_torch.examples import gnn_neighbor_sampling
from repro_torch.launch import bfs as launch_bfs
from repro_torch.launch import serve_bfs as launch_serve_bfs
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.gnn.gcn import gcn_params_from_numpy
from repro_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_are_found():
    names = {p.relative_to(PORT).as_posix() for p in PORT_FILES
             if p.is_relative_to(PORT)}
    assert {"core/hybrid.py", "core/packed.py", "core/msbfs.py",
            "kernels/common.py", "kernels/bottom_up_probe/kernel.py",
            "kernels/topdown_scan/kernel.py", "kernels/msbfs_probe/kernel.py",
            "kernels/segment_or/kernel.py", "graph/graph500.py",
            "launch/bfs.py", "benchmarks/msbfs_teps.py",
            "kernels/semiring_relax/kernel.py",
            "kernels/semiring_relax/ref.py", "kernels/semiring_relax/ops.py",
            "kernels/relax_fallback/kernel.py",
            "kernels/relax_fallback/ref.py", "kernels/relax_fallback/ops.py",
            "traversal/semiring.py", "traversal/sssp.py", "traversal/ref.py",
            "benchmarks/sssp_teps.py",
            "configs/base.py", "configs/gnn_shapes.py", "configs/gcn_cora.py",
            "configs/all.py", "configs/reduced.py", "optim/adamw.py",
            "models/layers.py", "models/gnn/common.py", "models/gnn/gcn.py",
            "data/pipeline.py", "train/checkpoint.py", "train/trainer.py",
            "launch/train.py", "kernels/ell_spmm/kernel.py",
            "kernels/ell_spmm/ref.py", "kernels/ell_spmm/ops.py",
            "kernels/spmm_residue/kernel.py", "kernels/spmm_residue/ref.py",
            "kernels/spmm_residue/ops.py", "analytics/__init__.py",
            "analytics/api.py", "analytics/closeness.py",
            "analytics/components.py", "analytics/diameter.py",
            "analytics/engine.py", "analytics/khop.py", "analytics/meta.py",
            "analytics/weighted.py", "graph/sampler.py",
            "benchmarks/table2_switching.py", "benchmarks/table3_maxpos.py",
            "benchmarks/table4_counters.py", "benchmarks/fig3_teps.py",
            "benchmarks/analytics_bench.py", "benchmarks/timing.py",
            "obs/__init__.py", "obs/metrics.py", "obs/sweeplog.py",
            "obs/traceviz.py", "obs/slo.py", "obs/doctor.py",
            "obs/server.py", "serving/__init__.py", "serving/stats.py",
            "serving/admission.py", "serving/trace.py",
            "serving/service.py", "launch/serve_bfs.py",
            "core/exchange.py", "core/dist_bfs.py", "core/dist_msbfs.py",
            "distributed/__init__.py", "distributed/compression.py",
            "distributed/ranks.py", "benchmarks/dist_msbfs_teps.py",
            "core/dist2d.py", "core/dist_sssp.py",
            "benchmarks/dist2d_teps.py",
            "benchmarks/dist_sssp_teps.py", "serving/frontdoor.py",
            "examples/__init__.py", "examples/quickstart.py",
            "examples/weighted_sssp.py", "examples/graph_analytics.py",
            "examples/serve_analytics.py", "examples/sweep_trace.py",
            "examples/distributed_bfs.py", "models/params.py",
            "models/gnn/gin.py", "models/gnn/egnn.py", "models/gnn/mace.py",
            "models/gnn/sph.py", "models/recsys/__init__.py",
            "models/recsys/dien.py", "configs/gin_tu.py",
            "configs/egnn_arch.py", "configs/mace_arch.py",
            "configs/dien_arch.py", "launch/serve.py",
            "examples/gnn_neighbor_sampling.py", "launch/mesh.py",
            "launch/flops.py", "launch/roofline.py", "launch/dryrun.py",
            "launch/bfs_dryrun.py", "distributed/sharding.py",
            "benchmarks/roofline.py", "distributed/spmd.py",
            "distributed/aggregate.py", "train/sharded.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_reference_import(path):
    assert not imported_roots(path) & set(FORBIDDEN)


_BLOCKED_IMPORT = """
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, {src!r})
import repro_torch
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
sys.path.insert(0, {repo!r})
import chip_smoke
assert not any(m.split(".")[0] in {blocked!r} for m in sys.modules)
print("ok")
"""


def test_package_imports_with_jax_and_reference_blocked():
    code = _BLOCKED_IMPORT.format(blocked=FORBIDDEN, src=str(REPO / "src"),
                                  repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_gpu):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rmat_graph(6, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uniform_random_graph(10, 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_edges(np.array([0, 1]), np.array([1, 2]), 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy_graph(np.array([0, 1]), np.array([0]), np.array([0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rmat_weighted_graph(6, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        uniform_random_weighted_graph(10, 20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_weighted_edges(np.array([0, 1]), np.array([1, 2]),
                            np.array([0.5, 1.0]), 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_numpy_weighted_graph(np.array([0, 1]), np.array([0]),
                                  np.array([0]), np.array([1.0]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sssp_teps.main(["--scale", "6", "--sources", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analytics_bench.main(["--scale", "6"])
    for script in (table2_switching, table3_maxpos, table4_counters):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main(["--scale", "6"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fig3_teps.main(["--scales", "6", "--edgefactors", "4"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_graph500(6, 4, num_roots=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_bfs.main(["--scale", "6", "--roots", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve_bfs.main(["--scale", "6", "--queries", "2"])
    for script in (dist_msbfs_teps, dist2d_teps, dist_sssp_teps):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main(["--smoke"])


def test_training_entry_points_raise_without_gpu(no_gpu):
    arch = reduce_arch("gcn-cora")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(arch, "full_graph_sm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "gcn-cora", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_batch(arch, arch.shape("full_graph_sm"), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gcn_params_from_numpy({"layers": [{"w": np.zeros((2, 2))}]})
    dien = reduce_arch("dien")
    for arch_id, shape_id in (("gin-tu", "molecule"), ("egnn", "molecule"),
                              ("mace", "molecule"),
                              ("dien", "train_batch")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(reduce_arch(arch_id), shape_id)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recsys_batch(dien, dien.shape("serve_p99"), 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "dien", "--reduced", "--requests", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_neighbor_sampling.main([])


def test_explicit_cpu_still_runs(no_gpu):
    g = rmat_graph(6, 4, device="cpu")
    assert g.device.type == "cpu" and g.row_ptr.dtype == torch.int32


def _run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
