"""The port's examples (``repro_torch.examples``) on the CPU.

Each example's ``main`` runs with ``--device cpu`` (``distributed_bfs`` on
four gloo ranks, ``--ndev 4``, a (1, 2, 2) mesh; ``weighted_sssp`` at its
``--scale 8``) and must pass its own
asserts, which are the reference scripts' (``examples/*.py``). What an
example prints that does not depend on the clock (graph sizes, the BFS
layer directions, the k-hop counts, components, diameter bounds, the
replays' done and layers, the recorded sweeps) is held against the same
reference functions at the same sizes, computed in one child process that
starts with the module.
"""
import json
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.examples import (distributed_bfs, graph_analytics,
                                  quickstart, serve_analytics, serve_lm,
                                  sweep_trace, train_lm, weighted_sssp)

REF_CODE = """
import json
import numpy as np
from repro.analytics import (ComponentsQuery, DiameterQuery, KHopQuery,
                             LaneEngine, run_query)
from repro.core.hybrid import bfs
from repro.graph.generator import rmat_graph, rmat_weighted_graph, sample_roots
from repro.obs import Telemetry
from repro.serving import AnalyticsService, ServiceConfig, synthetic_trace
from repro.traversal import sssp_pipelined

out = {}
g = rmat_graph(13, 16, seed=0)
root = int(sample_roots(g, 1, seed=1)[0])
layers = {}
for mode in ("hybrid", "hybrid_nosimd", "topdown"):
    r = bfs(g, root, mode)
    layers[mode] = "".join("TB"[d] for d in
                           np.asarray(r.trace_dir)[:int(r.num_layers)])
out["quickstart"] = dict(n=g.n, m=g.m, root=root, layers=layers)

g = rmat_graph(12, 16, seed=0)
root = int(sample_roots(g, 1, seed=1)[0])
out["distributed_bfs"] = dict(n=g.n, m=g.m, root=root, num_layers=int(
    bfs(g, root, "hybrid").num_layers))

g = rmat_graph(10, 8, seed=0)
eng = LaneEngine(g, lanes=None)
comps = run_query(eng, ComponentsQuery(batch=64))
seeds = sample_roots(g, 4, seed=2)
hops = run_query(eng, KHopQuery(sources=tuple(int(s) for s in seeds), k=2))
diam = run_query(eng, DiameterQuery(num_seeds=4, sweeps=3, seed=3))
out["graph_analytics"] = dict(
    n=g.n, m=g.m, components=int(comps.num_components),
    largest=[int(x) for x in comps.largest],
    khop_counts=[int(c) for c in hops.counts],
    diameter=[int(diam.lower), int(diam.upper)])

wg = rmat_weighted_graph(10, 8, seed=0)
trace = synthetic_trace(wg.n, 24, mix="bfs:3,khop:3,reach:2,sssp:2", seed=1,
                        burst=4, every=2, tenants=("t0", "t1"))
stats = AnalyticsService(wg, slots=64, sssp_slots=16).replay(trace)
out["serve_analytics"] = {k: stats[k] for k in (
    "requests", "done", "rejected", "layers", "answered_early_frac",
    "sojourn_layers")}

wg = rmat_weighted_graph(10, 16, seed=7)
tel = Telemetry()
svc = AnalyticsService(wg, ServiceConfig(lanes=64, slots=64, sssp_slots=16,
                                         telemetry=tel))
stats = svc.replay(synthetic_trace(wg.n, 24, mix="bfs:3,khop:2,reach:1,sssp:1",
                                   seed=3))
out["sweep_trace"] = dict(
    requests=stats["requests"], done=stats["done"], layers=stats["layers"],
    answered_early_frac=stats["answered_early_frac"],
    sweeps=[[s["engine"], s["kind"], s["layers"], s["edges_relaxed"]]
            for s in (r.summary() for r in tel.sweeps)])

wg = rmat_weighted_graph(8, 16, 0)
roots = sample_roots(wg, 8, seed=1)
res = sssp_pipelined(wg, roots, lanes=4)
out["weighted_sssp"] = dict(
    n=wg.n, m=wg.m,
    reached=[int(np.isfinite(np.asarray(res.dist[:, i])).sum())
             for i in range(3)],
    steps=[int(res.steps[i]) for i in range(3)])
from repro.configs.reduced import reduce_arch
out["train_lm"] = dict(params=reduce_arch("phi4-mini-3.8b").model_cfg
                       .param_count())
cfg = reduce_arch("qwen3-moe-30b-a3b").model_cfg
out["serve_lm"] = dict(params=cfg.param_count(), experts=cfg.moe.num_experts,
                       top_k=cfg.moe.top_k)
print("REF_EXAMPLES " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    """The reference's values, from a child started with the module's
    first test; the port's examples run meanwhile."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(run_in_subprocess, REF_CODE, devices=1)
    yield lambda: json.loads(
        future.result().split("REF_EXAMPLES ", 1)[1].splitlines()[0])
    pool.shutdown()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The examples on a few torch threads (restored after the module)."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def dist_bfs_run(ref):
    """``distributed_bfs`` on four gloo ranks, started with the module."""
    pool = ThreadPoolExecutor(1)
    future = pool.submit(distributed_bfs.main, ["--device", "cpu",
                                                "--ndev", "4"])
    yield future
    pool.shutdown()


def test_quickstart(ref, dist_bfs_run):
    got = quickstart.main(["--device", "cpu"])
    want = ref()["quickstart"]
    for key in ("n", "m", "root", "layers"):
        assert got[key] == want[key], key
    assert got["msbfs_edges"] > 0 and got["pipelined_edges"] > 0


def test_weighted_sssp(ref):
    # its own --scale flag at 8: its exact weighted closeness sweeps all n
    # sources, about a minute on the CPU at the default 10
    got = weighted_sssp.main(["--device", "cpu", "--scale", "8"])
    want = ref()["weighted_sssp"]
    for key in ("n", "m", "reached", "steps"):
        assert got[key] == want[key], key
    assert got["dijkstra_ok"] and got["unit_anchor"]


def test_graph_analytics(ref):
    got = graph_analytics.main(["--device", "cpu"])
    want = ref()["graph_analytics"]
    assert (got["n"], got["m"], got["components"]) == \
        (want["n"], want["m"], want["components"])
    assert list(got["largest"]) == want["largest"]
    assert got["khop_counts"] == want["khop_counts"]
    assert list(got["diameter"]) == want["diameter"]
    assert got["served_early"]


def test_serve_analytics(ref):
    got = serve_analytics.main(["--device", "cpu"])
    assert got["replay"] == ref()["serve_analytics"]
    assert got["quota"][1] == "REJECTED"


def test_sweep_trace(ref, tmp_path):
    got = sweep_trace.main(["--device", "cpu", "--out-dir", str(tmp_path)])
    want = ref()["sweep_trace"]
    for key in ("requests", "done", "layers", "answered_early_frac"):
        assert got[key] == want[key], key
    assert [list(s) for s in got["sweeps"]] == want["sweeps"]
    with open(got["trace_out"]) as f:
        assert json.load(f)
    with open(got["metrics_out"]) as f:
        assert "service_requests_total" in f.read()


def test_distributed_bfs(ref, dist_bfs_run):
    got = dist_bfs_run.result()
    want = ref()["distributed_bfs"]
    for key in ("n", "m", "root", "num_layers"):
        assert got[key] == want[key], key
    assert got["match"] and got["shape"] == (1, 2, 2)
    assert distributed_bfs.mesh_shape(8) == (2, 2, 2)
    assert distributed_bfs.mesh_shape(1) == (1, 1, 1)


def test_train_lm(ref, tmp_path, capsys):
    """A few of the reference's 200 steps, its prints, then a rerun with
    more steps resumes from the last checkpoint (every 50 steps)."""
    ckpt = str(tmp_path / "ckpt")
    got = train_lm.main(["--device", "cpu", "--steps", "60", "--ckpt-dir",
                         ckpt])
    assert got["params"] == ref()["train_lm"]["params"]
    assert got["arch"] == "phi4-mini-3.8b-reduced" and got["steps"] == 60
    assert [m["step"] for m in got["log"]] == [20, 40, 60]
    assert got["log"][-1]["loss"] < got["log"][0]["loss"]
    out = capsys.readouterr().out
    assert f"({got['params']:,} params) for 60 steps" in out
    assert "final loss:" in out
    again = train_lm.main(["--device", "cpu", "--steps", "80", "--ckpt-dir",
                           ckpt, "--arch", "phi4-mini-3.8b"])
    assert [m["step"] for m in again["log"]] == [80]


def test_serve_lm(ref, capsys):
    got = serve_lm.main(["--device", "cpu"])
    want = ref()["serve_lm"]
    assert got["tokens"].shape == (4, 16)
    out = capsys.readouterr().out
    assert (f"({want['params']:,} params, MoE {want['experts']} experts "
            f"top-{want['top_k']})") in out
    assert "served 4 requests x 16 tokens" in out
    assert torch.equal(serve_lm.main(["--device", "cpu"])["tokens"],
                       got["tokens"])


def test_examples_raise_without_gpu(monkeypatch):
    """The examples run on the GPU unless told otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for example in (quickstart, weighted_sssp, graph_analytics,
                    serve_analytics, sweep_trace, distributed_bfs, train_lm,
                    serve_lm):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            example.main([])
