"""The port at 64-bit lane words against the JAX package at 64-bit words.

Both packages read ``LANE_WORD_BITS`` when they are imported, so the
comparisons run in child processes started with ``LANE_WORD_BITS=64`` and
``JAX_ENABLE_X64=1`` (the reference's uint64 words need jax's x64 mode, set
before jax loads), the reference and the port in the same child, through
``conftest.run_in_subprocess``. Each child runs several groups of
comparisons and prints one ``<group> OK`` line per group; each test holds
one group's line. The port's int64 words are compared as the reference's
uint64 words, and every output is an integer array or its wire JSON, so the
tolerance is exact equality, unmasked for the probe. The port runs on the
CPU through the kernels' plain versions, on the int32 view of its words.

The tests that launch the CUDA kernels on int64 words need a GPU and skip
without one; they use neither JAX nor the JAX package:

  PYTHONPATH=src python -m pytest -q tests/test_torch_u64.py -k cuda
"""
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.core.csr import from_edges
from repro_torch.core.packed import bottomup_packed_step
from repro_torch.graph.generator import rmat_graph
from repro_torch.kernels import common
from repro_torch.kernels.msbfs_probe.ops import msbfs_probe
from repro_torch.kernels.msbfs_probe.ref import msbfs_probe_ref
from repro_torch.kernels.segment_or.ops import segment_or_rows
from repro_torch.kernels.segment_or.ref import segment_or_rows_ref

U64_ENV = {"LANE_WORD_BITS": "64", "JAX_ENABLE_X64": "1"}

PRELUDE = """
import json
import time
import numpy as np
import jax.numpy as jnp
import torch
from repro.core import packed as jp
from repro_torch.core import packed as tp
from repro_torch.core.csr import from_numpy_graph, from_numpy_weighted_graph

assert jp.LANE_WORD_BITS == tp.LANE_WORD_BITS == 64
assert jp.word_dtype() == jnp.uint64
assert tp.word_dtype() == torch.int64 and tp.host_word_dtype() is np.uint64


def u64(t):
    return t.numpy().view(np.uint64)


def same(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if got.dtype == np.int64 and want.dtype == np.uint64:
        got = got.view(np.uint64)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=str(what))


def port_graph(jg):
    return from_numpy_graph(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                            np.asarray(jg.src_idx), "cpu")


def port_weighted(jwg):
    return from_numpy_weighted_graph(
        *(np.asarray(getattr(jwg, f))
          for f in ("row_ptr", "col_idx", "src_idx", "weights")), "cpu")


_T0 = [time.perf_counter()]


def ok(group):
    t = time.perf_counter()
    print(group, "OK", round(t - _T0[0], 2), flush=True)
    _T0[0] = t
"""

# the packed helpers, the probe, both engines, the engine state, the lane
# pool rule and the batched harness
CORE_CODE = PRELUDE + """
import jax
from repro.core import msbfs as jms
from repro.graph import graph500 as jg500
from repro.graph.generator import rmat_graph as jrmat
from repro.graph.generator import sample_roots
from repro.kernels.msbfs_probe.ref import msbfs_probe_ref as jprobe_ref
from repro_torch.core import msbfs as tms
from repro_torch.graph.graph500 import run_graph500
from repro_torch.kernels.msbfs_probe.ops import msbfs_probe

rng = np.random.default_rng(0)


def rand_words(shape):
    return rng.integers(0, 2 ** 64, shape, dtype=np.uint64)


# jitted once per shape: eagerly the reference's scans and sums compile op
# by op on every call
j_pack = jax.jit(jp.pack_lanes)
j_unpack = jax.jit(jp.unpack_lanes, static_argnums=1)
j_band = jax.jit(jp.depth_slice_words)
j_segment_or = jax.jit(jp.segment_or)

# -- packed helpers: dtype, shape and values as uint64, at R across words --
for r in (1, 63, 64, 65, 128):
    mask = rng.random((17, r)) < 0.5
    want = j_pack(jnp.asarray(mask))
    got = tp.pack_lanes(torch.from_numpy(mask))
    assert got.dtype == torch.int64 and got.shape == want.shape, r
    same(got, want, ("pack", r))
    same(tp.pack_lanes_np(mask[5]), np.asarray(want)[5], ("pack_np", r))
    back = tp.unpack_lanes(got, r)
    assert back.dtype == torch.bool and back.shape == (17, r)
    same(back, j_unpack(want, r), ("unpack", r))
    same(back, mask, ("roundtrip", r))
    depth = rng.integers(-1, 5, size=(29, r)).astype(np.int32)
    for band in ((2, 0), (1, 1), (4, 3)):
        same(tp.depth_slice_words(torch.from_numpy(depth), *band),
             j_band(jnp.asarray(depth), *band), ("band", r))
# lane 63 is the int64 word's sign bit
top = np.zeros((3, 64), bool)
top[1, 63] = True
same(tp.pack_lanes(torch.from_numpy(top)),
     np.array([[0], [1 << 63], [0]], np.uint64), "lane 63")
same(tp.unpack_lanes(tp.pack_lanes(torch.from_numpy(top)), 64), top,
     "lane 63 back")
# segment_or: empty rows, trailing rows whose start is m, lane 63
hi = 1 << 63
row_ptr = np.array([0, 2, 2, 3, 3], np.int32)
vals = np.array([[1, hi], [4 + hi, 2], [8, hi + 1]], np.uint64)
got = tp.segment_or(torch.from_numpy(vals.view(np.int64)),
                    torch.from_numpy(row_ptr))
assert got.dtype == torch.int64
same(got, j_segment_or(jnp.asarray(vals), jnp.asarray(row_ptr)),
     "segment_or rows")
same(got, np.array([[5 + hi, hi + 2], [0, 0], [8, hi + 1], [0, 0]],
                   np.uint64), "segment_or values")
jg = jrmat(9, 8, seed=1)
g = port_graph(jg)
vals = rand_words((g.m, 2)) & rand_words((g.m, 2)) & rand_words((g.m, 2))
same(tp.segment_or(torch.from_numpy(vals.view(np.int64)), g.row_ptr),
     j_segment_or(jnp.asarray(vals), jg.row_ptr), "segment_or rmat")
ok("packed")

# -- B3 on the int32 view against the reference's u64 path, unmasked --
for w in (1, 2, 3):
    for max_pos in (1, 8):
        need = rand_words((g.n, w)) & rand_words((g.n, w))
        fro = rand_words((g.n, w)) & rand_words((g.n, w)) & rand_words(
            (g.n, w))
        want = jprobe_ref(jg.row_ptr[:-1], jg.deg, jnp.asarray(need),
                          jg.col_idx, jnp.asarray(fro), max_pos)
        got = msbfs_probe(g.row_ptr, g.col_idx,
                          torch.from_numpy(fro.view(np.int64)),
                          torch.from_numpy(need.view(np.int64)), max_pos)
        assert got.dtype == torch.int64 and got.shape == (g.n, w)
        same(got, want, ("probe", w, max_pos))
ok("probe")

# -- all 8 MSBFSResult fields, both engines, three modes --
FIELDS = tms.MSBFSResult._fields


def same_result(got, want, what):
    for f in FIELDS:
        t = getattr(got, f)
        assert t.dtype == torch.int32, (what, f)
        same(t, getattr(want, f), (what, f))


for mode in ("hybrid", "topdown", "bottomup"):
    for num_roots, lanes in ((70, 64), (20, 8)):
        roots = sample_roots(jg, num_roots, seed=11)
        want = jms.msbfs_pipelined(jg, jnp.asarray(roots), mode,
                                   lanes=lanes)
        got = tms.msbfs_pipelined(g, roots, mode, lanes=lanes)
        same_result(got, want, ("pipelined", mode, num_roots, lanes))
    roots = sample_roots(jg, 64, seed=3)
    want = jms.msbfs(jg, jnp.asarray(roots), mode)
    got = tms.msbfs(g, roots, mode)
    same_result(got, want, ("msbfs", mode))
    for band in ((2, 0), (1, 1), (None, 0)):
        same(got.reached_words(*band), want.reached_words(*band),
             ("reached_words", mode, band))
ok("results")

# -- a reference PipelineState of uint64 words carried across --


def same_state(got, want, what):
    cap = got.capacity
    for name in want._fields:
        a, b = getattr(got, name), np.asarray(getattr(want, name))
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        if name.startswith(("out_", "trace_")):
            a, b = a[..., :cap], b[..., :cap]
        if a.dtype != b.dtype and a.dtype.itemsize == b.dtype.itemsize:
            a = a.view(b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{name} {what}")


roots = sample_roots(jg, 100, seed=16)
js = jms.msbfs_engine_enqueue(jms.msbfs_engine_init(jg, 100, 72),
                              jnp.asarray(roots))
for _ in range(3):
    js = jms.msbfs_engine_step(jg, js, "hybrid")
assert js.frontier.dtype == jnp.uint64 and js.frontier.shape == (g.n, 2)
ts = tms.pipeline_state_from_numpy(
    {f: np.asarray(getattr(js, f)) for f in js._fields}, "cpu")
assert ts.frontier.dtype == torch.int64
same_state(ts, js, "carried")
steps = 0
while not jms.msbfs_engine_idle(js):
    js = jms.msbfs_engine_step(jg, js, "hybrid")
    ts = tms.msbfs_engine_step(g, ts, "hybrid")
    steps += 1
    same_state(ts, js, ("step", steps))
    want, got = jms.msbfs_engine_readout(js), tms.msbfs_engine_readout(ts)
    same(got.slice_words(2), want.slice_words(2), ("slice_words", steps))
assert tms.msbfs_engine_idle(ts) and steps > 0
same_result(tms.msbfs_engine_result(g, ts), jms.msbfs_engine_result(jg, js),
            "carried result")
ok("state")

# -- the lane pool rule rounds to whole 64-bit words --
for pending in (1, 5, 33, 64, 65, 100, 300):
    for n, m in ((1000, 1500), (1000, 6000), (1 << 20, 1 << 25),
                 (1 << 24, 1 << 26)):
        got = tp.adaptive_lane_pool(pending, n, m)
        assert got == jp.adaptive_lane_pool(pending, n, m), (pending, n, m)
        assert got % 64 == 0
ok("lane_pool")

# -- the batched Graph500 harness --
want = jg500.run_graph500(9, 8, num_roots=40, seed=0, graph=jg,
                          batched=True, lanes=64)
got = run_graph500(9, 8, num_roots=40, seed=0, graph=g, batched=True,
                   lanes=64, validate=True)
assert got.roots == [int(r) for r in sample_roots(jg, 40, seed=1)]
assert got.traversed == want.traversed
for key in ("scale", "edgefactor", "mode", "batched", "lanes", "nroots"):
    assert got.summary()[key] == want.summary()[key], key
adaptive = run_graph500(9, 8, mode="bottomup_simd", num_roots=5, seed=0,
                        graph=g, batched=True, lanes=None)
assert adaptive.lanes == jp.adaptive_lane_pool(5, g.n, g.m) == 64
ok("graph500")
"""

# the sweep recorder, the khop wire and a service replay
SERVE_CODE = PRELUDE + """
from repro import analytics as ja
from repro import obs as jobs
from repro.analytics import api as japi
from repro.core.msbfs import msbfs_pipelined as jmsbfs_pipelined
from repro.graph.generator import rmat_weighted_graph as jrmat_weighted
from repro.serving import AnalyticsService as JService
from repro.serving import synthetic_trace as jsynthetic_trace
from repro_torch import analytics as ta
from repro_torch import obs
from repro_torch.analytics import api as tapi
from repro_torch.core.msbfs import msbfs_pipelined
from repro_torch.serving import AnalyticsService, synthetic_trace

jwg = jrmat_weighted(8, 8, seed=11)
wg = port_weighted(jwg)
n = wg.n


def record_fields(records):
    return [{k: v for k, v in r.as_dict().items() if k != "wall_ms"}
            for r in records]


# -- LayerRecords of a recorded sweep, every field but wall_ms --
for num_roots, lanes in ((24, 8), (90, 72)):
    roots = np.arange(num_roots, dtype=np.int32) * 7 % n
    jrec = jobs.SweepRecorder(engine="msbfs")
    want = jmsbfs_pipelined(jwg.csr, roots, lanes=lanes, recorder=jrec)
    rec = obs.SweepRecorder(engine="msbfs")
    got = msbfs_pipelined(wg.csr, roots, lanes=lanes, recorder=rec)
    same(got.depth, want.depth, ("recorded depth", lanes))
    a, b = record_fields(rec.records), record_fields(jrec.records)
    assert a == b, (lanes, a[:2], b[:2])
    assert a and all(r["frontier_words"] <= n * -(-lanes // 64) for r in a)
ok("sweeplog")


# -- khop words as uint64, through the wire byte for byte --
def wire(api, result):
    return json.dumps(api.result_to_wire(result), sort_keys=True)


for lanes in (None, 64):
    jeng = ja.LaneEngine(jwg, lanes=lanes)
    teng = ta.LaneEngine(wg, lanes=lanes)
    for sources, k in (((3, 9, 15, 0), 2), (tuple(range(0, 210, 3)), 3)):
        q = dict(sources=sources, k=k)
        want = ja.run_query(jeng, ja.KHopQuery(**q))
        got = ta.run_query(teng, ta.KHopQuery(**q))
        assert got.words.dtype == want.words.dtype == np.uint64
        same(got.words, want.words, ("khop words", lanes, k))
        same(got.member_mask(), want.member_mask(), ("members", lanes, k))
        assert wire(tapi, got) == wire(japi, want), (lanes, k)
        assert '"<u8"' in wire(tapi, got)
ok("khop_wire")

# -- a small service replay: every answer's wire --
MIX = "bfs:3,khop:3,reach:1,closeness:1,sssp:1"
want_trace = jsynthetic_trace(n, 20, mix=MIX, seed=2, burst=4)
got_trace = synthetic_trace(n, 20, mix=MIX, seed=2, burst=4)
for i, (a, b) in enumerate(zip(want_trace, got_trace)):
    a.id = b.id = f"r{i}"
jsvc = JService(jwg, slots=32, sssp_slots=8)
jstats = jsvc.replay(want_trace)
svc = AnalyticsService(wg, slots=32, sssp_slots=8)
stats = svc.replay(got_trace)
assert svc._packed.lanes == jsvc._packed.lanes == 64
clock = ("wall_s", "aggregate_mteps")
assert ({k: v for k, v in stats.items() if k not in clock}
        == {k: v for k, v in jstats.items() if k not in clock})
answered = 0
for env in want_trace:
    a, b = svc.record(env.id), jsvc.record(env.id)
    for f in ("status", "engine", "slots", "submit_layer", "dispatch_layer",
              "answer_layer", "answered_early"):
        assert getattr(a, f) == getattr(b, f), (env.id, f)
    if b.answer is not None:
        answered += 1
        assert (json.dumps(a.answer.to_wire(include_result=True),
                           sort_keys=True)
                == json.dumps(b.answer.to_wire(include_result=True),
                              sort_keys=True)), env.id
assert answered == len(want_trace)
ok("replay")
"""

# the knob refuses a width other than 32 or 64 when the port is imported
BAD_WIDTH_CODE = """
try:
    import repro_torch.core.packed
except ValueError as exc:
    print("RAISED", exc)
else:
    print("IMPORTED")
"""


def ok_lines(out):
    """The child's "<group> OK" lines, without the seconds each took."""
    return {" ".join(line.split()[:2]) for line in out.splitlines()}


@pytest.fixture(scope="module")
def core_out():
    return run_in_subprocess(CORE_CODE, devices=1, env_extra=U64_ENV)


@pytest.fixture(scope="module")
def serve_out():
    return run_in_subprocess(SERVE_CODE, devices=1, env_extra=U64_ENV)


@pytest.mark.parametrize("group", ["packed", "probe", "results", "state",
                                   "lane_pool", "graph500"])
def test_engine_matches_reference_at_64_bits(core_out, group):
    assert f"{group} OK" in ok_lines(core_out), core_out


@pytest.mark.parametrize("group", ["sweeplog", "khop_wire", "replay"])
def test_serving_matches_reference_at_64_bits(serve_out, group):
    assert f"{group} OK" in ok_lines(serve_out), serve_out


def test_bad_word_width_raises_at_import():
    out = run_in_subprocess(BAD_WIDTH_CODE, devices=1,
                            env_extra={"LANE_WORD_BITS": "48"})
    assert "RAISED LANE_WORD_BITS must be 32 or 64, got 48" in out, out


def test_int64_words_take_the_int32_view_on_the_cpu():
    """In this process the words are 32 bits wide, but the wrappers take
    int64 words by their dtype: the result equals the plain version on the
    int32 view, viewed back, and no kernel is launched."""
    g = rmat_graph(8, 8, seed=4, device="cpu")
    rng = np.random.default_rng(4)
    fro = torch.from_numpy(rng.integers(0, 2 ** 63, (g.n, 2)))
    need = torch.from_numpy(rng.integers(0, 2 ** 63, (g.n, 2)))
    before = dict(common.LAUNCHES)
    acc = msbfs_probe(g.row_ptr, g.col_idx, fro, need, 8)
    assert acc.dtype == torch.int64 and acc.shape == (g.n, 2)
    want = msbfs_probe_ref(g.row_ptr[:-1], g.row_ptr.diff(),
                           need.view(torch.int32), g.col_idx,
                           fro.view(torch.int32), 8)
    assert torch.equal(acc.view(torch.int32), want)
    out = segment_or_rows(g.row_ptr, g.col_idx, fro, ~need, sel=need[0])
    assert out.dtype == torch.int64
    assert torch.equal(out.view(torch.int32), segment_or_rows_ref(
        g.row_ptr, g.col_idx, fro.view(torch.int32),
        (~need).view(torch.int32), need[0].view(torch.int32)))
    assert common.LAUNCHES == before


# ---------------------------------------------------------------------------
# On the card: B3 and both forms of X1 on int64 words
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def int64_words(n, w, seed, device):
    """Seeded int64[n, w] (frontier, visited) words, bit 63 included."""
    rng = np.random.default_rng(seed)

    def words():
        return torch.from_numpy(rng.integers(0, 2 ** 64, (n, w),
                                             dtype=np.uint64).view(np.int64))
    vis = words() & words()
    return (words() & ~vis).to(device), vis.to(device)


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("max_pos", [1, 8])
def test_msbfs_probe_cuda_int64_words(cuda_device, w, max_pos):
    g = rmat_graph(12, 16, seed=w, device=cuda_device)
    fro, vis = int64_words(g.n, w, w, cuda_device)
    need = ~vis
    before = common.LAUNCHES["msbfs_probe"]
    got = msbfs_probe(g.row_ptr, g.col_idx, fro, need, max_pos)
    torch.cuda.synchronize()
    assert common.LAUNCHES["msbfs_probe"] == before + 1
    assert got.dtype == torch.int64 and got.shape == (g.n, w)
    want = msbfs_probe_ref(g.row_ptr[:-1].cpu(), g.row_ptr.diff().cpu(),
                           need.cpu().view(torch.int32), g.col_idx.cpu(),
                           fro.cpu().view(torch.int32), max_pos)
    assert torch.equal(got.cpu().view(torch.int32), want)


@pytest.mark.parametrize("w", [1, 2, 3])
@pytest.mark.parametrize("form", ["topdown", "fallback"])
def test_segment_or_cuda_int64_words(cuda_device, w, form):
    g = rmat_graph(12, 16, seed=w + 7, device=cuda_device)
    fro, vis = int64_words(g.n, w, w + 7, cuda_device)
    if form == "topdown":
        kw = dict(mask=~vis, sel=vis[0].clone())
    else:
        base = int64_words(g.n, w, w + 8, cuda_device)[0]
        active = torch.from_numpy(np.random.default_rng(w).random(g.n)
                                  < 0.3).to(cuda_device)
        kw = dict(mask=~vis, base=base, row_active=active, min_pos=8)
    before = common.LAUNCHES["segment_or"]
    got = segment_or_rows(g.row_ptr, g.col_idx, fro, **kw)
    torch.cuda.synchronize()
    assert common.LAUNCHES["segment_or"] == before + 1
    assert got.dtype == torch.int64 and got.shape == (g.n, w)
    cpu = {k: (v.cpu().view(torch.int32) if isinstance(v, torch.Tensor)
               and v.dtype == torch.int64 else
               v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    want = segment_or_rows_ref(g.row_ptr.cpu(), g.col_idx.cpu(),
                               fro.cpu().view(torch.int32), **cpu)
    assert torch.equal(got.cpu().view(torch.int32), want)


def test_engine_on_int64_words_launches_the_kernels(cuda_device):
    """A CUDA tensor of int64 words goes through the kernels on its int32
    view, never through the plain version: a bottom-up packed step on a
    small graph launches B3 and X1."""
    g = from_edges(np.arange(99), np.arange(1, 100), 100, device=cuda_device)
    fro, vis = int64_words(g.n, 2, 3, cuda_device)
    before = dict(common.LAUNCHES)
    new = bottomup_packed_step(g, fro, vis | fro,
                               torch.full((2,), -1, dtype=torch.int64,
                                          device=cuda_device), 1)
    torch.cuda.synchronize()
    assert new.dtype == torch.int64
    assert common.LAUNCHES["msbfs_probe"] == before["msbfs_probe"] + 1
    assert common.LAUNCHES["segment_or"] == before["segment_or"] + 1
