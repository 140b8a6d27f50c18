"""CPU tests of the harness: runs of tiny cells through the real drivers and
readers; a configuration of another generator, a driver with another loop
and metrics added as files of a temporary directory; the check that must
fail under each fault a cell can have, under its control, and when the
program writes to its data; and the import of the harness without JAX. The
cells of ``BENCHMARK.json`` themselves run on the card
(``test_cell_on_card``)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import graphs  # noqa: E402
import harness  # noqa: E402

CPU = torch.device("cpu")
TINY = dict(generator="graph500_kronecker", scale=7, edgefactor=8,
            abcd=[0.57, 0.19, 0.19, 0.05], symmetrize=True,
            drop_self_loops=True, dedup=False, graph_seed=1)
TRAFFIC = dict(roots_per_request=16, warm_requests=1, check_from=1,
               check_requests=1, trace_requests=1)
# tiny cells on the real drivers, each in the place of a cell of
# BENCHMARK.json: (weighted, traffic of its own)
CELLS = {
    "tiny-parents": (False, dict(driver="bfs_sweep", lanes=16,
                                 derive_parents=True)),
    "tiny-depths": (False, dict(driver="bfs_sweep", lanes=None,
                                derive_parents=False)),
    "tiny-sssp": (True, dict(driver="sssp_sweep")),
}
STANDS_FOR = {"s20-g500-parents": "tiny-parents",
              "s20-depths-64": "tiny-depths", "s20w-sssp-64": "tiny-sssp"}

# a configuration of another generator, a driver with another loop, and a
# metric of each kind, all added as files
RING = '''"""A ring of n vertices with a chord from each to 7i + 3 (mod n)."""
import torch

import graphs


def build(cfg, seed, device):
    n = cfg["n"]
    i = torch.arange(n, device=device)
    return graphs.build_csr(torch.cat([i, i]),
                            torch.cat([(i + 1) % n, (7 * i + 3) % n]), n)
'''
OPEN_LOOP = '''"""Open loop: one root a request, arriving every interval_s whether
or not the last has finished; a latency counts from the arrival."""
import time

import graphs
import loops
import plain


class Program:
    def __init__(self, graph, traffic, seed, device):
        from repro_torch.analytics.engine import LaneEngine
        from repro_torch.core.csr import CSRGraph
        self.device, self.interval = device, traffic["interval_s"]
        self.requests = requests(graph, traffic, seed)
        self.engine = LaneEngine(CSRGraph(graph.row_ptr, graph.col_idx,
                                          graph.src_idx))

    def loop(self, salt):
        t0 = time.perf_counter()
        for i, roots in enumerate(self.requests(salt)):
            arrival = t0 + i * self.interval
            time.sleep(max(0.0, arrival - time.perf_counter()))
            out = self.engine.sweep(roots)
            loops.sync(self.device)
            yield loops.Record(time.perf_counter() - arrival,
                               {"requests": 1}, roots, {"depth": out.depth})


def requests(graph, traffic, seed):
    return graphs.RootRequests(graph, 1, seed)


def check(graph, samples, traffic):
    bad = sum(int((kept["depth"][:, 0] != plain.bfs_depths(
        graph.row_ptr, graph.col_idx, int(roots[0]))).sum())
        for roots, kept in samples)
    return {"depth_mismatch": (bad, 0)}, int(bad > 0)


def control(graph, roots, traffic):
    return {"depth": plain.bfs_depths(graph.row_ptr, graph.col_idx,
                                      int(roots[0]), 1)[:, None]}


def faults(traffic):
    return {}
'''
REQUESTS_PER_S = '''"""requests_per_s: an end-to-end metric added as a file."""


def read(w):
    return sum(r.work["requests"] for r in w.records) / w.seconds
'''
REQUESTS_TRACED = '''"""requests_traced: a per-layer metric added as a file."""


def read(t):
    return float(t.requests)
'''


def tiny_root(tmp: Path) -> Path:
    """A checkout of its own: ``BENCHMARK.json`` naming the benchmark's
    directory and a new one, ``extra``, which holds tiny configurations in
    place of the cells' own, their traffic, and the ring cell: a
    configuration of another generator, a driver with another loop and an
    end-to-end metric; and a per-layer metric of the parents cell."""
    extra = tmp / "extra"
    for d in ("configs", "workloads", "metrics", "generators", "drivers"):
        (extra / d).mkdir(parents=True)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["paths"] = [str(BENCH), "extra"]
    spec["configs"], spec["workloads"] = [], []
    configs = {"tiny": dict(TINY, weighted=False),
               "tiny-w": dict(TINY, weighted=True, weight_range=[0.0, 1.0]),
               "ring": dict(generator="ring", n=50)}
    for name, cfg in configs.items():
        (extra / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append(dict(name=name, source="test", reduced=[],
                                    file=f"extra/configs/{name}.json",
                                    why="test"))
    cells = {cell: ("tiny-w" if weighted else "tiny", dict(TRAFFIC, **t))
             for cell, (weighted, t) in CELLS.items()}
    cells["ring-open"] = ("ring", dict(TRAFFIC, driver="open_loop",
                                       interval_s=0.002, check_from=3))
    for cell, (config, traffic) in cells.items():
        (extra / "workloads" / f"{cell}.json").write_text(json.dumps(traffic))
        spec["workloads"].append(dict(name=cell, traffic=cell, chips=1,
                                      config=config, why="test"))
    (extra / "generators" / "ring.py").write_text(RING)
    (extra / "drivers" / "open_loop.py").write_text(OPEN_LOOP)
    (extra / "metrics" / "requests_per_s.py").write_text(REQUESTS_PER_S)
    (extra / "metrics" / "requests_traced.py").write_text(REQUESTS_TRACED)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [STANDS_FOR[c] for c in m["workloads"]]
    spec["end_to_end"].append(dict(
        name="requests_per_s", unit="1/s", better="higher", bound=0.05,
        source="host_clock", workloads=["ring-open"]))
    spec["per_layer"].append(dict(
        name="requests_traced", unit="1", better="higher",
        source="program_counter", layer="Harness", moves="teps.parents",
        workloads=["tiny-parents"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return harness.Spec(tiny_root(tmp_path_factory.mktemp("tiny")))


def run(spec, cell, trace=False, seed=2 ** 31 + 5, seconds=0.0):
    return harness.run(spec, cell, seed, seconds, trace, 0.0, CPU,
                       log=lambda line: None)


def reported(spec, cell, kind):
    return {m["name"] for m in (spec.end_to_end(spec.cell(cell))
                                if kind == "end_to_end" else
                                spec.per_layer(spec.cell(cell)))}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_is_correct(spec, cell):
    result, checks = run(spec, cell)
    assert result["correct"] and result["failed"] == 0, checks
    assert result["attempted"] >= TRAFFIC["check_from"]
    assert set(result["metrics"]) == reported(spec, cell, "end_to_end")
    rate = [v["value"] for k, v in result["metrics"].items()
            if k.startswith("teps.")]
    assert len(rate) == 1 and rate[0] > 0
    assert all(v <= lim for v, lim in checks.values())


def test_a_new_cell_and_metric_are_data(spec):
    """A configuration of another generator, a driver with another loop,
    an end-to-end metric (and, in the traced test below, a per-layer one),
    all from files of a temporary directory; nothing of the benchmark's
    own files changed to take them."""
    result, checks = run(spec, "ring-open", seconds=0.3)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"requests_per_s", "peak_gb", "setup_s"}
    assert result["attempted"] >= 3
    assert result["metrics"]["requests_per_s"]["value"] <= 1 / 0.002 * 1.05


def test_a_traced_run_reads_its_layers(spec):
    result, _ = run(spec, "tiny-parents", trace=True)
    m = result["metrics"]
    assert m["parents_ms"]["value"] > 0 and m["engine_ms.parents"]["value"] > 0
    assert m["requests_traced"]["value"] == TRAFFIC["trace_requests"]
    # no device here: nothing ran on one, and no kernel's roofline is read
    assert m["device_idle_pct.parents"]["value"] == pytest.approx(100.0)
    assert "msbfs_probe_roofline.parents" not in m
    assert result["device"]["window_s"] > 0 and result["correct"]


def test_teps_counts_whole_requests(spec):
    lines = []
    harness.run(spec, "tiny-depths", 3, 0.3, False, 0.0, CPU,
                log=lines.append)
    window = json.loads(lines[1])
    cell = harness.Cell(spec, "tiny-depths", 3, CPU, program=False)
    edges = graphs.component_edges(cell.data)
    stream = cell.driver.requests(cell.data, cell.traffic, 3)(
        harness.ROOT_SALT)
    assert window["work"]["edges"] == sum(
        int(edges[next(stream)].sum()) for _ in range(window["requests"]))
    assert window["window_s"] >= 0.3


def test_the_reference_keeps_its_own_data(spec):
    """A program that writes to its graph in place is judged against the
    graph as it was made: here one that turns every edge into a self-loop
    before it sweeps, and answers for that graph."""
    def make(orig):
        def sweep(self, roots, *args, **kwargs):
            self.g.col_idx.copy_(self.g.src_idx)
            return orig(self, roots, *args, **kwargs)
        return sweep
    with harness.Patches() as p:
        p.wrap("repro_torch.analytics.engine:LaneEngine.sweep", make)
        result, checks = run(spec, "tiny-depths")
    assert not result["correct"] and checks["depth_mismatch"][0] > 0


class Event:
    def __init__(self, name, start, end, device=False):
        self.name = name
        self.time_range = type("R", (), dict(start=start, end=end))
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)


def test_profile_reading():
    """The window, busy time as a union, kernel time by short name, the
    annotation ranges left out, and idle gaps named by the innermost host
    event over their middle."""
    import profiling
    events = [
        Event(profiling.WINDOW, 0, 100), Event("engine_ms.parents", 6, 90),
        Event("engine_ms.parents", 6, 90, device=True),
        Event("aten::sum", 20, 30), Event("cudaStreamSynchronize", 22, 28),
        Event("void (anonymous namespace)::k<2>(int const*)", 10, 20, True),
        Event("void (anonymous namespace)::k<2>(int const*)", 15, 25, True),
        Event("Memcpy DtoH", 40, 60, True), Event("aten::where", 61, 70),
        Event("late", 95, 130, True)]
    t = profiling.Trace()
    profiling.read_profile(events, t, {"engine_ms.parents"})
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)     # 10-25, 40-60, 95-100
    # a kernel's time is the sum of its launches, overlapping or not
    assert t.kernel_s == pytest.approx({"k<2>": 20e-6, "Memcpy DtoH": 20e-6,
                                        "late": 5e-6})
    # gaps 0-10 (outside any op), 25-40 (mid 32.5: the span), 60-95 (mid
    # 77.5: the span; aten::where ended at 70)
    assert dict(t.idle_gaps) == pytest.approx({
        "host outside any traced op": 10e-6, "engine_ms.parents": 50e-6})


def driver_faults(traffic):
    return harness.load_module(BENCH / "drivers" / f"{traffic['driver']}.py",
                               "bench_drivers").faults(traffic)


# every fault that each tiny cell's driver names
FAULTS = [(c, f) for c, (_, t) in sorted(CELLS.items())
          for f in driver_faults(t)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_program_is_not_correct(spec, cell, fault):
    import control
    got = control.fault_readings(spec, cell, fault, 2 ** 31 + 5, 0.0, CPU)
    assert not got["correct"] and got["failed"] > 0, got


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(spec, cell):
    import control
    got = control.readings(spec, cell, 11, CPU)
    assert not got["correct"] and got["failed"] > 0, got


def test_no_jax_module_is_loaded_by_a_run(tmp_path):
    """In a process of its own: every module of the benchmark loaded, and a
    run of a tiny cell of each driver."""
    code = ("import sys, pathlib; sys.path[:0] = {paths!r}\n"
            "import harness, test_bench_harness as t\n"
            "spec = harness.Spec(t.tiny_root(pathlib.Path({tmp!r})))\n"
            "[spec.module('metrics', m['name']) for m in "
            "spec.data['per_layer'] + spec.data['end_to_end']]\n"
            "for c in ('tiny-depths', 'tiny-sssp', 'ring-open'): "
            "t.run(spec, c)\n"
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(
        paths=[str(BENCH), str(ROOT / "src")], tmp=str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "harness" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_a_loaded_jax_module_refuses_the_run(monkeypatch, capsys):
    import run as command
    monkeypatch.setitem(sys.modules, "jax", sys)
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert {"jax", "repro.core"} <= set(harness.forbidden_modules())
    assert "repro_torch" not in harness.forbidden_modules()
    with pytest.raises(SystemExit) as exit_:
        command.refuse_forbidden(harness.forbidden_modules())
    assert exit_.value.code == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_the_command_needs_the_card_and_the_program(tmp_path, monkeypatch,
                                                  capsys):
    """Without a card, and in a directory with the benchmark's files and
    nothing else, the command exits 2 and prints no result."""
    import run as command
    argv = ["--workload", "s20-depths-64", "--seed", "1", "--seconds", "1"]
    if not torch.cuda.is_available():
        for name in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR"):
            monkeypatch.setenv(name, "")
        monkeypatch.setattr(sys, "path", list(sys.path))
        with pytest.raises(SystemExit) as exit_:
            command.main(argv)
        assert exit_.value.code == 2
        out = capsys.readouterr()
        assert out.out == "" and "no CUDA device" in out.err
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, str(tmp_path / "bench" / "run.py")] + argv,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "the program" in out.stderr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA "
                    "kernels, which have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_on_card(spec, cell, cuda_device):
    result, checks = harness.run(spec, cell, 7, 0.5, True, 0.0,
                                 cuda_device, log=lambda line: None)
    assert result["correct"], checks
    assert result["device"]["busy_s"] > 0
