"""CPU tests of the readers of the program's own spans and counters
(``program_spans.py``, the metrics ``engine_host_ms``, ``host_wait_ms``,
``entry_host_ms``, ``host_syncs`` and ``lane_occupancy`` of each cell): a
tiny traced cell of each driver reads a number for each; the breakdown
names idle time after the program's phases; a program without the spans,
as before they were added, reads None and leaves the metrics out."""
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import harness  # noqa: E402
import profiling  # noqa: E402
import program_spans  # noqa: E402
import test_bench_harness as tiny  # noqa: E402

READERS = ("engine_host_ms", "host_wait_ms", "entry_host_ms", "host_syncs",
           "lane_occupancy")
# each tiny cell in the place of a cell of BENCHMARK.json, by metric suffix
SUFFIX = {"tiny-parents": "parents", "tiny-depths": "depths",
          "tiny-sssp": "sssp"}


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return harness.Spec(tiny.tiny_root(tmp_path_factory.mktemp("spans")))


def traced(spec, cell):
    return tiny.run(spec, cell, trace=True)[0]


@pytest.mark.parametrize("cell", sorted(SUFFIX))
def test_each_program_metric_reads_a_number(spec, cell):
    result = traced(spec, cell)
    assert result["correct"]
    m = {k: v["value"] for k, v in result["metrics"].items()}
    got = {name: m[f"{name}.{SUFFIX[cell]}"] for name in READERS}
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["engine_host_ms"] > 0 and got["entry_host_ms"] > 0
    assert got["host_wait_ms"] >= 0 and got["host_syncs"] >= 3
    assert 0 < got["lane_occupancy"] <= 100
    # the engine's host work lies inside the benchmark's span of the drain
    engine = m[f"engine_ms.{SUFFIX[cell]}"]
    assert got["engine_host_ms"] <= engine


def host_paced(read_profile):
    """``profiling.read_profile`` with each host aten op also taken as a
    device op over the same time: the device busy exactly while the host
    is inside an op, and idle while it runs the program's own Python, as a
    host-paced cell on the card."""
    class Op:
        device_type = torch.autograd.DeviceType.CUDA
        is_user_annotation = False

        def __init__(self, e):
            self.name, self.time_range = "k_" + e.name, e.time_range

    def read(events, trace, annotations):
        events = list(events)
        ops = [Op(e) for e in events if e.name.startswith("aten::")]
        return read_profile(events + ops, trace, annotations)
    return read


@pytest.mark.parametrize("cell,phase", [("tiny-depths", "msbfs."),
                                        ("tiny-sssp", "sssp.")])
def test_idle_is_named_after_the_program_phases(spec, cell, phase,
                                                monkeypatch):
    monkeypatch.setattr(profiling, "read_profile",
                        host_paced(profiling.read_profile))
    monkeypatch.setattr(profiling, "TOP", 1000)
    result = traced(spec, cell)
    gaps = dict(result["breakdown"]["idle_gaps"])
    idle = result["device"]["window_s"] - result["device"]["busy_s"]
    assert sum(gaps.values()) == pytest.approx(idle, rel=1e-6)
    # the engine's host work is named after its phases, not after the
    # drain or a step as a whole, nor after the benchmark's own span: those
    # keep the spans' own cost, which on the CPU is a larger share of a
    # tiny step than on the card
    phases = {k: v for k, v in gaps.items() if k.startswith(phase)
              and not k.endswith((".drain", ".step"))}
    whole = sum(v for k, v in gaps.items() if k.endswith((".drain", ".step"))
                or k.startswith("engine_ms"))
    assert f"{phase}flush" in phases and f"{phase}plan" in phases
    assert whole < 0.25 * sum(phases.values())


def test_a_program_without_spans_reads_none(spec, monkeypatch):
    """As on a checkout from before the spans: ``repro_torch.obs`` has no
    ``spans``, the readers read None and the line leaves the metrics
    out."""
    import repro_torch.obs
    monkeypatch.delattr(repro_torch.obs, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.spans", None)
    t = profiling.Trace(requests=1)
    assert all(getattr(program_spans, name)(t) is None for name in READERS)
    result = traced(spec, "tiny-depths")
    assert result["correct"]
    assert not any(k.split(".")[0] in READERS for k in result["metrics"])


def test_fewer_sweeps_than_requests_read_none():
    from repro_torch.obs import spans
    t = profiling.Trace(requests=spans.MAX_SWEEPS + 1)
    assert all(getattr(program_spans, name)(t) is None for name in READERS)
