"""The port's hillclimb, table runner and serving bench
(``repro_torch.benchmarks.bfs_hillclimb``, ``run``, ``serve_bench``)
against the reference's scripts under ``benchmarks/``.

The port runs on the CPU, through the kernels' plain versions. Times are
not compared. Every hillclimb point's per-root traversed edges must equal
the reference harness's at the same knobs, the runner's counter headlines
must equal the reference runner's, and the serving bench must pass its own
asserts and give the reference's early-answer points, which count layers,
not seconds.
"""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.graph.generator import rmat_graph as jrmat
from repro.graph.graph500 import run_graph500 as jrun_graph500
from repro_torch.benchmarks import bfs_hillclimb, serve_bench
from repro_torch.benchmarks import run as bench_run
from repro_torch.core.csr import from_numpy_graph
from repro_torch.graph.generator import rmat_weighted_graph
from repro_torch.graph.graph500 import run_graph500

REPO = Path(__file__).resolve().parent.parent
SCALE, EDGEFACTOR, ROOTS = 8, 4, 8


def reference_script(name):
    """A reference script under ``benchmarks/``, loaded from its file; its
    own ``benchmarks.<x>`` imports resolve from the repository root."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", REPO / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def graphs():
    jg = jrmat(SCALE, EDGEFACTOR, seed=0)
    g = from_numpy_graph(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                         np.asarray(jg.src_idx), "cpu")
    return jg, g


@pytest.mark.parametrize("point", bfs_hillclimb.points(),
                         ids=[p[2].replace(" ", "") for p in
                              bfs_hillclimb.points()])
def test_hillclimb_point_traverses_reference_edges(graphs, point):
    jg, g = graphs
    section, key, label, knobs = point
    want = jrun_graph500(SCALE, EDGEFACTOR, num_roots=ROOTS, seed=0,
                         graph=jg, **knobs)
    got = run_graph500(SCALE, EDGEFACTOR, num_roots=ROOTS, seed=0, graph=g,
                       **knobs)
    assert got.traversed == want.traversed, label
    assert got.mode == knobs["mode"] and len(got.teps) == ROOTS


def labels(printed):
    """The point lines of a hillclimb's output, without their numbers."""
    return [ln.rsplit(None, 2)[0] for ln in printed.splitlines()
            if ln.endswith(" MTEPS")]


def test_hillclimb_run_matches_reference(tmp_path, capsys, monkeypatch):
    """The whole script at scale 6: the same points, printed in the same
    order under the same labels, and the same JSON sections and keys."""
    ref = reference_script("bfs_hillclimb")
    monkeypatch.setattr(ref, "ART", str(tmp_path / "ref"))
    want = ref.run(6, 8, roots=2)
    want_printed = capsys.readouterr().out
    got = bfs_hillclimb.main(["--scale", "6", "--edgefactor", "8",
                              "--roots", "2", "--device", "cpu",
                              "--out", str(tmp_path / "port")])
    printed = capsys.readouterr().out
    assert labels(printed) == labels(want_printed)
    assert len(labels(printed)) == len(bfs_hillclimb.points()) == 19
    saved = json.loads((tmp_path / "port" / "bfs_perf_s6_ef8.json")
                       .read_text())
    assert saved["device"] == got["device"] == "cpu"
    assert set(got) == set(want) | {"device"}
    for section in ("ladder", "max_pos_sweep", "alpha_beta_sweep",
                    "fallback_ablation", "ell_topdown"):
        assert list(got[section]) == list(want[section]), section
        assert all(v > 0 for v in got[section].values()), section


@pytest.mark.parametrize("name", ["table2_switching", "table3_maxpos"])
def test_run_headline_matches_reference(capsys, name):
    """The runner's counter headlines (Table 2's bottom-up layers, Table
    3's retired fraction) at the reference runner's default sizes."""
    ref = reference_script("run")
    want = dict(ref.BENCHES)[name](False)[1]
    bench_run.main(["--only", name, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert "name,us_per_call,derived" in lines
    row = [ln for ln in lines if ln.startswith(f"{name},")]
    assert len(row) == 1 and row[0].split(",")[2] == want
    assert [n for n, _ in bench_run.BENCHES] == [n for n, _ in ref.BENCHES]


def test_run_roofline_over_records(capsys, tmp_path, monkeypatch):
    """``--only roofline`` reads the dry-run's records under the working
    directory (no device): the 16x16 cells with all three terms and a
    compute term, the best roofline fraction among them, in the reference
    runner's format."""
    recs = tmp_path / "artifacts" / "dryrun_torch"
    recs.mkdir(parents=True)

    def put(name, **rec):
        (recs / f"{name}.json").write_text(json.dumps(rec))

    def terms(frac):
        return dict(compute_s=frac, memory_s=1.0, collective_s=0.5,
                    dominant="memory", step_time_bound_s=1.0,
                    roofline_fraction=frac)

    put("bfs-a", kind="dist_bfs", mesh="pod16x16", status="ok",
        roofline=terms(0.25))
    put("bfs-b", kind="dist_bfs", mesh="pod2x16x16", status="ok",
        roofline=terms(0.75))
    # no compute term, as a BFS layer counts no FLOPs: no fraction to rank
    put("bfs-c", kind="dist_bfs", mesh="pod16x16", status="ok",
        roofline=terms(0.0))
    put("lm", arch="phi4-mini-3.8b", shape="train_4k", kind="train",
        mesh="pod16x16", status="ok", roofline=terms(0.5))
    put("lm-skip", arch="phi4-mini-3.8b", shape="decode_32k",
        kind="decode", mesh="pod16x16", status="skipped",
        roofline=dict(compute_s=0.1, memory_s=None, collective_s=None,
                      dominant=None, roofline_fraction=None))
    monkeypatch.chdir(tmp_path)
    bench_run.main(["--only", "roofline"])
    lines = capsys.readouterr().out.splitlines()
    row = [ln for ln in lines if ln.startswith("roofline,")]
    assert len(row) == 1
    assert row[0].split(",")[2] == "cells=2;best_frac=0.500@phi4-mini-3.8b/train_4k"
    for r in recs.glob("*.json"):
        r.unlink()
    bench_run.main(["--only", "roofline"])
    assert capsys.readouterr().out.splitlines()[-1].endswith(",cells=0")
    with pytest.raises(SystemExit):
        bench_run.main(["--only", "nonesuch", "--device", "cpu"])


@pytest.fixture(scope="module")
def few_threads():
    """A few torch threads for the replays: under a loaded CPU (other test
    files' ranks) a replay on every core's thread crawled, and its rounded
    rate read 0. Restored after the module."""
    old = torch.get_num_threads()
    torch.set_num_threads(min(old, 2))
    yield
    torch.set_num_threads(old)


def test_serve_bench_matches_reference(few_threads):
    """Scale 8, 16 queries: the port's bench passes its asserts (bit
    parity of streamed and flushed answers, gain >= 1 layer) and counts the
    reference's layers, on the graph it builds and on one it is given."""
    want = reference_script("serve_bench").bench_points(8, queries=16)
    got = serve_bench.bench_points(8, queries=16, device="cpu")
    given = serve_bench.bench_points(    # on a graph the caller built
        8, queries=16, graph=rmat_weighted_graph(8, 16, 0, device="cpu"))
    assert list(got) == list(given) == list(want)
    for name in got:
        if not name.startswith("mix_teps"):
            assert got[name] == given[name] == want[name], name
    assert got["early_gain_layers_s8_q16"] >= 1.0
    assert got["mix_teps_s8_q16"] > 0


def test_serve_bench_ndev_raises(few_threads):
    """``ndev > 1`` runs on the ranks of a process group
    (``tests/test_torch_serving_dist.py``): without one it raises and says
    how to launch."""
    with pytest.raises(RuntimeError, match="run_ranks"):
        serve_bench.bench_points(8, queries=4, ndev=2, device="cpu")


def test_scripts_raise_without_gpu(monkeypatch):
    """The three scripts run on the GPU unless told otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bfs_hillclimb.main(["--scale", "6", "--roots", "2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_run.main(["--only", "table2_switching"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bench.main(["--scale", "6", "--queries", "2"])
