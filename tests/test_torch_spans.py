"""The port's own spans and counters (``repro_torch.obs.spans``) on the
analytics entry's sweeps.

With the torch profiler off a sweep records nothing and opens no profiler
range. Under ``torch.profiler.profile`` each ``LaneEngine.sweep`` and
``.sssp_sweep`` leaves one sweep record: every span carries its id and lies
inside its parent, the engine's steps lie inside the drain and are covered
by their phases, ``host_syncs`` counts every blocking transfer the sweep
makes (counted here by patching the sync sites), the lane counters give an
occupancy in [0, 100], and the answers are bit-identical to an unrecorded
sweep. The port runs on the CPU through the kernels' plain versions.
"""
import numpy as np
import pytest
import torch

from repro_torch.analytics.engine import LaneEngine
from repro_torch.core import msbfs, packed
from repro_torch.graph.generator import rmat_weighted_graph
from repro_torch.obs import spans
from repro_torch.traversal import sssp

ROOTS = np.arange(3, 43)           # 40 roots: more than the pool's lanes
BFS_PHASES = {"msbfs.refill", "msbfs.plan", "msbfs.dispatch",
              "msbfs.counters", "msbfs.readback", "msbfs.flush"}
SSSP_PHASES = {"sssp.prepare", "sssp.plan", "sssp.relax", "sssp.update",
               "sssp.readback", "sssp.flush"}
# (sweep kind, the call, its drain span, its step's phases)
SWEEPS = {
    "depths": ("analytics.sweep", lambda e: e.sweep(ROOTS), "msbfs.drain",
               BFS_PHASES),
    "parents": ("analytics.sweep",
                lambda e: e.sweep(ROOTS, derive_parents=True),
                "msbfs.drain", BFS_PHASES),
    "sssp": ("analytics.sssp_sweep", lambda e: e.sssp_sweep(ROOTS),
             "sssp.drain", SSSP_PHASES),
}


@pytest.fixture(scope="module")
def engine():
    return LaneEngine(rmat_weighted_graph(7, 8, seed=3, device="cpu"),
                      lanes=32)


def profiled(fn):
    """``fn()`` under the torch profiler; returns (its result, the sweep
    records it left)."""
    before = {sw.id for sw in spans.recent()}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [sw for sw in spans.recent() if sw.id not in before], prof


def answers(kind, res):
    if kind == "sssp":
        return (res.dist, res.steps)
    return (res.depth, res.parent, res.num_layers, res.edges_traversed)


@pytest.mark.parametrize("kind", sorted(SWEEPS))
def test_off_records_nothing(engine, kind, monkeypatch):
    """Off, a site opens no profiler range and records nothing."""
    _, call, _, _ = SWEEPS[kind]
    opened = []
    monkeypatch.setattr(spans, "_RANGE", lambda name: opened.append(name))
    before = [sw.id for sw in spans.recent()]
    call(engine)
    assert [sw.id for sw in spans.recent()] == before
    assert opened == []


@pytest.mark.parametrize("kind", sorted(SWEEPS))
def test_a_profiled_sweep_records_one_nested_sweep(engine, kind):
    entry, call, drain, phases = SWEEPS[kind]
    _, recs, prof = profiled(lambda: call(engine))
    assert len(recs) == 1
    sw = recs[0]
    assert sw.kind == entry and sw.spans[0].name == entry
    assert [s.parent for s in sw.spans].count(-1) == 1
    for i, s in enumerate(sw.spans):
        assert s.sweep == sw.id and s.end_ns >= s.start_ns > 0
        if i:
            assert 0 <= s.parent < i
            up = sw.spans[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns
    # the spans are the profiler's ranges too, on the trace's clock
    names = {e.name for e in prof.events()}
    assert {s.name for s in sw.spans} <= names


@pytest.mark.parametrize("kind", sorted(SWEEPS))
def test_steps_lie_inside_the_drain_and_their_phases_cover_them(engine,
                                                                kind):
    _, call, drain, phases = SWEEPS[kind]
    _, (sw,), _ = profiled(lambda: call(engine))
    drains = [i for i, s in enumerate(sw.spans) if s.name == drain]
    steps = [i for i, s in enumerate(sw.spans)
             if s.name == drain.replace("drain", "step")]
    assert len(drains) == 1 and len(steps) > 1
    assert all(sw.spans[i].parent == drains[0] for i in steps)
    covered = 0
    for i in steps:
        kids = [s for s in sw.spans if s.parent == i]
        assert {s.name for s in kids} == phases
        covered += sum(s.ns for s in kids)
    # the phases cover the steps' bodies, their bookkeeping included: what
    # is left is the spans' own cost
    assert covered >= 0.85 * sum(sw.spans[i].ns for i in steps)


@pytest.mark.parametrize("kind", sorted(SWEEPS))
def test_host_syncs_counts_every_sync_site(engine, kind, monkeypatch):
    """Each read-back and pageable upload the sweep makes, counted here at
    the sites themselves, is one sync span and one ``host_syncs``; no
    read-back bypasses them."""
    _, call, _, _ = SWEEPS[kind]
    hits, reads = [], []

    def counted(fn):
        def site(*args):
            hits.append(args[-1])
            return fn(*args)
        return site

    for mod in (msbfs, sssp):
        monkeypatch.setattr(mod, "to_host", counted(packed.to_host))
        monkeypatch.setattr(mod, "upload", counted(packed.upload))
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda t, *a, **k: reads.append(1) or cpu(t, *a, **k))
    _, (sw,), _ = profiled(lambda: call(engine))
    syncs = [s.name for s in sw.spans if s.sync]
    assert sw.counts["host_syncs"] == len(hits) == len(syncs) > 0
    assert sorted(syncs) == sorted(hits)
    assert len(reads) == sum(not h.endswith(".upload") for h in hits)
    steps = sum(s.name.endswith(".step") for s in sw.spans)
    uploads = 5 if kind == "sssp" else 6
    # one read-back a step, the degrees (BFS) or the weights' maximum
    # (SSSP), and the result's uploads
    assert len(hits) == steps + 1 + uploads


@pytest.mark.parametrize("kind", sorted(SWEEPS))
def test_lane_occupancy_is_a_share_of_the_pool(engine, kind):
    _, call, _, _ = SWEEPS[kind]
    _, (sw,), _ = profiled(lambda: call(engine))
    steps = sum(s.name.endswith(".step") for s in sw.spans)
    pool = 32
    assert sw.counts["lanes_pool"] == steps * pool
    occupancy = 100.0 * sw.counts["lanes_live"] / sw.counts["lanes_pool"]
    assert 0.0 < occupancy <= 100.0


@pytest.mark.parametrize("kind", sorted(SWEEPS))
def test_answers_are_bit_identical_with_recording_on(engine, kind):
    _, call, _, _ = SWEEPS[kind]
    on, _, _ = profiled(lambda: call(engine))
    off = call(engine)
    for a, b in zip(answers(kind, on), answers(kind, off)):
        assert torch.equal(a, b)


def test_the_ring_keeps_the_newest_sweeps():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.count("outside", 3)                 # no sweep: dropped
        for i in range(spans.MAX_SWEEPS + 5):
            with spans.sweep("test.sweep"):
                spans.count("i", i)
        spans.count("outside", 3)                 # closed: dropped
    recs = spans.recent()
    assert len(recs) == spans.MAX_SWEEPS
    assert [sw.counts["i"] for sw in recs] == list(range(5, spans.MAX_SWEEPS
                                                         + 5))
    assert all(sw.counts == {"i": sw.counts["i"]} for sw in recs)
    ids = [sw.id for sw in recs]
    assert ids == sorted(ids)
    assert spans.recent(2) == recs[-2:] and spans.recent(0) == []
