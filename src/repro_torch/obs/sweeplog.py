"""Per-layer sweep flight recorder — ONE schema across every engine (port of
``repro.obs.sweeplog``).

The engines already account their work per layer, but each in its own
place: the MS-BFS engines write per-lane ``trace_dir``/``trace_vf``/
``trace_ef``/``trace_eu`` rows into their state, the SSSP engines write
``trace_bucket``/``trace_phase``, and the distributed engines meter
exchange bytes in ``exch_bytes``/``exch_log``. This module unifies them
behind one host-side record stream:

* ``LayerRecord`` — the canonical per-engine-step schema: sweep-step
  index, TD/BU (or light/heavy) mode, active lanes, frontier words set
  and density, edges relaxed, words touched, exchange bytes + wire
  format, wall ms — plus the per-lane detail (queue slot, the lane's own
  trace row, and the exact trace values) that makes the stream
  *bit-identical* to the engines' in-state traces.
* ``SweepRecorder`` — collects ``LayerRecord``s for one sweep,
  optionally feeding a ``MetricsRegistry`` and a JSONL flight sink;
  ``reconstruct_traces`` rebuilds the engine trace arrays from the
  record stream (the parity surface ``tests/test_obs.py`` pins against
  ``MSBFSResult``/``SSSPResult``).
* ``snapshot_state`` / ``record_step`` / ``drive_recorded`` — the
  host-side hook the engine drivers call when a recorder is passed:
  instead of the drain, the sweep is stepped layer by layer through the
  engine's own streaming API and each step's trace delta is read back.
  Recording is **off by default and zero-cost when disabled** — with
  ``recorder=None`` the drivers run the unchanged drain and nothing here
  executes.

In the port the traces are host numpy arrays already, so the trace diff
stays on the host. The frontier words and the SSSP distances are device
tensors: their nonzero / finite counts are taken on the device, the
pre-step distances are kept as a device clone (the step seats new sources
into ``dist`` in place), and only scalars cross to the host. ``wall_ms``
is the step alone: it starts once the snapshot's counts are read (which
waits for the device) and ends with a device sync on the card, so it
times the step's work and not just its launches. On a 2-D engine a rank
holds its row block of the frontier or the distances, so the counts are
summed along "row" (a collective: every rank records) and are the whole
graph's, as on every other engine.

How the delta read-back works: within one sweep every (trace row, queue
slot) cell is written at most once, from its init value (-1 direction /
-1 bucket) to a live value — so diffing the trace arrays across one step
recovers exactly the cells that step wrote, whichever lane wrote them
and wherever the lane was in its own layer counter. The one blind spot
is the SSSP trace row clip (steps past ``MAX_SSSP_TRACE`` overwrite the
last row): a clipped overwrite with identical bucket AND phase is
invisible to the diff — the reconstructed arrays still match the engine
bit-for-bit (the overwrite was idempotent), only the per-step lane list
of those tail steps is thinner.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field

import numpy as np
import torch

from repro_torch.core.exchange import GridComm, psum

__all__ = [
    "LayerRecord", "SweepRecorder", "drive_recorded", "record_step",
    "snapshot_state",
]

# mode strings per engine family (index = the trace's dir/phase value)
_BFS_MODES = ("td", "bu")
_SSSP_MODES = ("light", "heavy")


@dataclass(frozen=True)
class LayerRecord:
    """One engine step of one sweep, in the unified schema.

    ``dirs`` holds the engine's own trace values — TD(0)/BU(1) for the
    packed engines, light(0)/heavy(1) phase for the tropical ones — so
    the stream replays ``trace_dir``/``trace_phase`` bit-for-bit;
    ``buckets`` rides along for SSSP (empty for BFS), ``vf``/``ef``/
    ``eu`` for BFS (empty for SSSP). ``exch_bytes`` is the mesh-total
    wire bytes this step (0 on host engines — their exchange-equivalent
    work is ``edges_relaxed``/``words_touched``, the satellite that makes
    host and distributed sweep logs directly comparable).
    """
    layer: int                  # engine sweep-step index, 0-based
    engine: str                 # "msbfs" | "dist_msbfs" | "dist2d" | ...
    kind: str                   # "bfs" | "sssp"
    mode: str                   # td | bu | light | heavy | mixed | idle
    active_lanes: int
    frontier_words: int         # packed words set (BFS) / finite lane
    #                             entries (SSSP) entering the step
    frontier_density: float     # frontier_words / total storage words
    edges_relaxed: int          # BFS: e_f (TD) / e_u (BU) summed over
    #                             live lanes; SSSP: distances improved
    words_touched: int          # BFS: frontier words read + written;
    #                             SSSP: finite entries after the step
    exch_bytes: int             # exchange wire bytes this step
    exch_format: str            # "none" | "dense" | "compressed"
    wall_ms: float
    slots: tuple = ()           # queue slot per recorded lane (sorted)
    rows: tuple = ()            # the lane's own trace row this step
    dirs: tuple = ()            # trace_dir / trace_phase values
    vf: tuple = ()              # BFS frontier-vertex counts per lane
    ef: tuple = ()              # BFS frontier-edge counts per lane
    eu: tuple = ()              # BFS unvisited-edge counts per lane
    buckets: tuple = ()         # SSSP bucket index per lane

    def as_dict(self) -> dict:
        return asdict(self)


@dataclass
class SweepRecorder:
    """Record stream of one sweep; the one hook every engine emits to.

    ``registry`` (a ``metrics.MetricsRegistry``) and ``sink`` (anything
    with ``write(dict)`` — e.g. ``traceviz.FlightSink``) are optional
    fan-outs applied per record."""
    engine: str = ""
    meta: dict = field(default_factory=dict)
    registry: object = None
    sink: object = None
    kind: str = ""                       # set by the first record
    records: list = field(default_factory=list)

    def record(self, rec: LayerRecord) -> None:
        if not self.kind:
            self.kind = rec.kind
        self.records.append(rec)
        if self.registry is not None:
            self.registry.counter(
                "obs_sweep_layers_total", "engine steps recorded",
                ("engine", "mode")).labels(
                    engine=rec.engine, mode=rec.mode).inc()
            self.registry.counter(
                "obs_edges_relaxed_total", "edges relaxed per engine",
                ("engine",)).labels(engine=rec.engine).inc(
                    rec.edges_relaxed)
            if rec.exch_bytes:
                self.registry.counter(
                    "obs_exchange_bytes_total", "exchange wire bytes",
                    ("engine", "format")).labels(
                        engine=rec.engine,
                        format=rec.exch_format).inc(rec.exch_bytes)
        if self.sink is not None:
            self.sink.write(rec.as_dict())

    @property
    def num_layers(self) -> int:
        return len(self.records)

    def modes(self) -> list[str]:
        return [r.mode for r in self.records]

    def total(self, name: str) -> float:
        return sum(getattr(r, name) for r in self.records)

    def summary(self) -> dict:
        return dict(
            engine=self.engine, kind=self.kind, layers=self.num_layers,
            edges_relaxed=int(self.total("edges_relaxed")),
            exch_bytes=int(self.total("exch_bytes")),
            wall_ms=round(self.total("wall_ms"), 3), **self.meta)

    def reconstruct_traces(self, max_trace: int,
                           capacity: int) -> dict[str, np.ndarray]:
        """Rebuild the engine's per-root trace arrays from the record
        stream — BFS: ``trace_dir``/``trace_vf``/``trace_ef``/
        ``trace_eu``; SSSP: ``trace_bucket``/``trace_phase`` — shaped
        [max_trace, capacity] exactly like the engine buffers (minus the
        trailing trash column). The bit-for-bit parity surface."""
        if self.kind == "sssp":
            out = dict(
                trace_bucket=np.full((max_trace, capacity), -1, np.int32),
                trace_phase=np.full((max_trace, capacity), -1, np.int32))
            for r in self.records:
                for s, row, d, b in zip(r.slots, r.rows, r.dirs, r.buckets):
                    out["trace_bucket"][row, s] = b
                    out["trace_phase"][row, s] = d
            return out
        out = dict(
            trace_dir=np.full((max_trace, capacity), -1, np.int32),
            trace_vf=np.zeros((max_trace, capacity), np.int32),
            trace_ef=np.zeros((max_trace, capacity), np.int32),
            trace_eu=np.zeros((max_trace, capacity), np.int32))
        for r in self.records:
            for s, row, d, v, e, u in zip(r.slots, r.rows, r.dirs, r.vf,
                                          r.ef, r.eu):
                out["trace_dir"][row, s] = d
                out["trace_vf"][row, s] = v
                out["trace_ef"][row, s] = e
                out["trace_eu"][row, s] = u
        return out


# ---------------------------------------------------------------------------
# Host-side step hooks (called by the engine drivers when recording).
# ---------------------------------------------------------------------------


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def _grid_rows(state) -> GridComm | None:
    comm = getattr(state, "comm", None)
    return comm if isinstance(comm, GridComm) else None


def _counts(state, *counts: torch.Tensor) -> list[int]:
    """Device counts over the state's rows as host ints, summed over the
    grid column's row blocks on a 2-D state: the whole graph's counts."""
    total = torch.stack([c.to(torch.int64) for c in counts])
    grid = _grid_rows(state)
    if grid is not None:
        total = psum(total, grid.row)
    return [int(x) for x in total.cpu()]


def _total_words(state, t: torch.Tensor) -> int:
    grid = _grid_rows(state)
    return t.numel() * (1 if grid is None else grid.pr)


def snapshot_state(state, kind: str) -> dict:
    """Pre-step snapshot of the trace surfaces the step will write.

    The trace arrays are host [rows, capacity+1] arrays; the frontier /
    distance tensors carry each vertex once, so their nonzero / finite
    counts are taken on the device and read back as scalars."""
    exch = int(getattr(state, "exch_bytes", 0))
    if kind == "sssp":
        dist = state.dist.clone()       # the step seats sources in place
        return dict(
            trace_bucket=np.array(state.trace_bucket),
            trace_phase=np.array(state.trace_phase),
            dist=dist,
            frontier_words=_counts(state, torch.isfinite(dist).sum())[0],
            total_words=_total_words(state, dist),
            exch=exch,
            t0=time.perf_counter(),
        )
    frontier = state.frontier
    return dict(
        trace_dir=np.array(state.trace_dir),
        frontier_words=_counts(state, torch.count_nonzero(frontier))[0],
        total_words=_total_words(state, frontier),
        exch=exch,
        t0=time.perf_counter(),
    )


def _mode_of(dirs: np.ndarray, names: tuple) -> str:
    if dirs.size == 0:
        return "idle"
    lo, hi = int(dirs.min()), int(dirs.max())
    return names[lo] if lo == hi else "mixed"


def record_step(recorder: SweepRecorder, pre: dict, state, kind: str,
                exch_format: str = "none") -> None:
    """Diff ``state`` against the pre-step ``snapshot_state`` dict and
    append the step's ``LayerRecord`` (see module docstring for why the
    trace diff recovers exactly the cells the step wrote)."""
    cap = state.capacity
    _sync(state.dist if kind == "sssp" else state.frontier)
    wall_ms = round((time.perf_counter() - pre["t0"]) * 1e3, 6)
    exch_after = int(getattr(state, "exch_bytes", 0))
    step_bytes = exch_after - pre["exch"]
    if kind == "sssp":
        bucket = np.asarray(state.trace_bucket)
        phase = np.asarray(state.trace_phase)
        changed = ((bucket != pre["trace_bucket"])
                   | (phase != pre["trace_phase"]))
        changed[:, cap] = False
        rows, slots = np.nonzero(changed)
        order = np.argsort(slots, kind="stable")
        rows, slots = rows[order], slots[order]
        dirs = phase[rows, slots]
        dist = state.dist
        improved, finite = _counts(state, (dist < pre["dist"]).sum(),
                                   torch.isfinite(dist).sum())
        rec = LayerRecord(
            layer=int(state.sweep_steps) - 1, engine=recorder.engine,
            kind=kind, mode=_mode_of(dirs, _SSSP_MODES),
            active_lanes=int(slots.size),
            frontier_words=pre["frontier_words"],
            frontier_density=pre["frontier_words"]
            / max(pre["total_words"], 1),
            edges_relaxed=improved,
            words_touched=finite,
            exch_bytes=step_bytes, exch_format=exch_format,
            wall_ms=wall_ms,
            slots=tuple(int(x) for x in slots),
            rows=tuple(int(x) for x in rows),
            dirs=tuple(int(x) for x in dirs),
            buckets=tuple(int(x) for x in bucket[rows, slots]))
        recorder.record(rec)
        return
    trace_dir = np.asarray(state.trace_dir)
    changed = trace_dir != pre["trace_dir"]
    changed[:, cap] = False
    rows, slots = np.nonzero(changed)
    order = np.argsort(slots, kind="stable")
    rows, slots = rows[order], slots[order]
    dirs = trace_dir[rows, slots]
    vf = np.asarray(state.trace_vf)[rows, slots]
    ef = np.asarray(state.trace_ef)[rows, slots]
    eu = np.asarray(state.trace_eu)[rows, slots]
    # the paper's per-layer work counter: TD lanes inspect the frontier's
    # out-edges (e_f), BU lanes the unvisited set's (e_u)
    edges = int(np.where(dirs == 0, ef, eu).sum())
    frontier_after = _counts(state, torch.count_nonzero(state.frontier))[0]
    rec = LayerRecord(
        layer=int(state.sweep_layers) - 1, engine=recorder.engine,
        kind=kind, mode=_mode_of(dirs, _BFS_MODES),
        active_lanes=int(slots.size),
        frontier_words=pre["frontier_words"],
        frontier_density=pre["frontier_words"] / max(pre["total_words"], 1),
        edges_relaxed=edges,
        words_touched=pre["frontier_words"] + frontier_after,
        exch_bytes=step_bytes, exch_format=exch_format,
        wall_ms=wall_ms,
        slots=tuple(int(x) for x in slots),
        rows=tuple(int(x) for x in rows),
        dirs=tuple(int(x) for x in dirs),
        vf=tuple(int(x) for x in vf),
        ef=tuple(int(x) for x in ef),
        eu=tuple(int(x) for x in eu))
    recorder.record(rec)


def drive_recorded(recorder: SweepRecorder, state, step_fn, idle_fn, *,
                   kind: str, exch_format: str = "none"):
    """Step an engine to idleness, recording every layer — the recorded
    twin of the engines' drain loops. ``step_fn(state) -> state`` and
    ``idle_fn(state) -> bool`` are the engine's own streaming API, so the
    state sequence (and therefore every result and trace) is bit-identical
    to the drain's; only the host gets to look between layers."""
    while not idle_fn(state):
        pre = snapshot_state(state, kind)
        state = step_fn(state)
        record_step(recorder, pre, state, kind, exch_format)
    return state
