"""Bucketed delta-stepping SSSP: port of ``repro.traversal.sssp``.

Meyer & Sanders' delta-stepping as lane-batched tropical relaxations:

* R single-source problems occupy R dense float32 lanes (``dist[n, L]``,
  inf = unreached); sources stream through a fixed lane pool from a pending
  queue, claimed, flushed and refilled mid-sweep with the same
  ``packed.queue_claims`` rule as ``msbfs_pipelined``.
* Each lane walks its own buckets (bucket ``b`` holds the unsettled
  vertices with ``dist < (b+1)*delta``). Per engine step a lane either
  **iterates** (relaxes the light edges, ``w <= delta``, of the bucket
  members whose distance changed since they were last relaxed) or, once
  its bucket is at fixpoint, **settles** (relaxes the members' heavy edges
  once and jumps to the bucket of its least unsettled distance).

Both phases are one masked min-plus relaxation (``semiring.tropical_relax``:
inactive sources carry +inf values, excluded edges +inf weights), skipped
when no lane is in that phase. With unit weights and ``delta = 1`` bucket
``b`` is BFS layer ``b`` and the depths equal ``msbfs_pipelined``'s.

The reference runs a sweep as one on-device ``while_loop``; the port is a
host loop over engine steps, in the style of the pipelined MS-BFS engine
(``core/msbfs.py``). On the device: the lane distances ``dist``, the
``relaxed`` request flags, the flushed distances ``out_dist`` and the
light/heavy edge weights of each bucket width, computed once per width
(the reference recomputes them every step; the values are the same). On
the host: each lane's bucket, step count and queue slot, the queue, the
flushed step counts and truncation flags, and both traces. A step reads
the device back once: each lane's least unsettled distance, its next
bucket, and whether it iterates on the next step. These decide the next
step's phase skips, the bucket advance, exhaustion, the step cap and the
flushes. On a CUDA graph every relaxation goes through the
``semiring_relax`` and ``relax_fallback`` kernels; on the CPU it takes the
plain path that ``relax_impl`` names.

The engine also runs sharded (``core/dist_sssp.py``): a state whose
``comm`` is set relaxes the rank's block of the graph. On a 1-D partition
(``comm`` a ``MeshComm``) the values are replicated and the block's
candidates are MIN-exchanged over the mesh; on a 2-D grid (``comm`` a
``GridComm``) the values are row blocks, the step gathers the column
block's masked source values along "row" and MIN-folds the partial
candidates along "col", and the read-back's minima are taken over the grid
column first. The control is the same on every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.csr import WeightedCSRGraph
from repro_torch.core.exchange import (GridComm, exchange_expand_values,
                                       exchange_reduce_min, grid_sum, pmin)
from repro_torch.core.packed import queue_claims, to_device, to_host, upload
from repro_torch.device import resolve_device
from repro_torch.obs import spans
from repro_torch.traversal.semiring import INF, tropical_relax

__all__ = [
    "DEFAULT_LANES", "MAX_SSSP_STEPS", "MAX_SSSP_TRACE", "SSSPResult",
    "adaptive_delta", "default_delta", "sssp_engine_drain",
    "sssp_engine_enqueue", "sssp_engine_idle", "sssp_engine_init",
    "sssp_engine_result", "sssp_engine_step", "sssp_pipelined",
    "sssp_state_from_numpy",
]

# dense float lanes cost 32x the state of packed bit lanes, so the default
# pool is narrower than the MS-BFS engine's
DEFAULT_LANES = 32

# per-lane step bound: a safety net; a capped lane is flushed as truncated
MAX_SSSP_STEPS = 4096

# per-lane bucket/phase trace depth: rows are engine steps, clipped (steps
# past the buffer overwrite the last row, as in the reference)
MAX_SSSP_TRACE = 256


class SSSPResult(NamedTuple):
    # All on the graph's device, as in the reference.
    sources: torch.Tensor       # int32[R] root vertex per lane
    dist: torch.Tensor          # float32[n, R], inf unreached
    steps: torch.Tensor         # int32[R] engine steps the lane ran
    truncated: torch.Tensor     # bool[R] lane hit max_steps: dist is a
    #                             partial relaxation, not shortest paths
    trace_bucket: torch.Tensor  # int32[MAX_SSSP_TRACE, R] bucket per step
    #                             (-1 = lane idle / step never ran)
    trace_phase: torch.Tensor   # int32[MAX_SSSP_TRACE, R] 0 light-iterate,
    #                             1 heavy-settle, -1 idle

    def reached(self) -> torch.Tensor:
        """bool[n, R]: vertices with a finite distance per lane."""
        return torch.isfinite(self.dist)

    def as_depth(self) -> torch.Tensor:
        """int32[n, R] MS-BFS-style depths (-1 unreached), exact for unit
        weights, where distance equals hop count."""
        return torch.where(torch.isfinite(self.dist), torch.round(self.dist),
                           -1.0).to(torch.int32)


class SSSPState(NamedTuple):
    dist: torch.Tensor          # float32[n, L] lane distances (device; inf idle)
    relaxed: torch.Tensor       # bool[n, L] light edges relaxed at dist (device)
    lane_bucket: np.ndarray     # int32[L] current bucket per lane
    lane_steps: np.ndarray      # int32[L] steps run for the lane's root
    lane_qidx: np.ndarray       # int32[L] queue slot served; capacity = idle
    queue: np.ndarray           # int32[capacity] enqueued source ids
    queued: int                 # sources enqueued
    next_root: int              # next queue slot to claim
    sweep_steps: int            # engine steps run
    out_dist: torch.Tensor      # float32[n, capacity+1] (device)
    out_steps: np.ndarray       # int32[capacity+1]  0 = unanswered
    out_truncated: np.ndarray   # bool[capacity+1]  lane flushed by the cap
    trace_bucket: np.ndarray    # int32[MAX_SSSP_TRACE, capacity+1]
    trace_phase: np.ndarray     # int32[MAX_SSSP_TRACE, capacity+1]
    iterating: np.ndarray | None = None  # bool[L] lane has light requests
    #                                      pending; None = not read yet
    phase_w: dict | None = None          # bucket width -> (light, heavy) weights
    base: int = 0                        # global row of dist's row 0
    comm: object = None                  # MeshComm (1-D) or GridComm (2-D);
    #                                      None = one device
    exch_bytes: int = 0                  # exchange wire bytes, all ranks
    exch_log: np.ndarray | None = None   # int64[MAX_SSSP_TRACE] bytes per
    #                                      step; None = not metered

    @property
    def num_lanes(self) -> int:
        return self.lane_qidx.shape[0]

    @property
    def capacity(self) -> int:
        return self.queue.shape[0]

# Invariants (kept by _refill and the step), as in the MS-BFS engine: an
# idle lane (lane_qidx == capacity) holds inf distances and no relaxed
# flags; out_steps[q] > 0 <=> slot q has been answered. The out_* arrays
# keep the reference's trailing trash column for shape; the port writes
# only finished lanes, so it is never written.


def default_delta(wg: WeightedCSRGraph) -> float:
    """Meyer & Sanders' Theta(1/d) rule scaled to the weight range:
    ``max_w / avg_degree``; 1.0 on edgeless or all-zero-weight graphs."""
    if wg.m == 0:
        return 1.0
    w_max = float(to_host(wg.weights.max(), "sssp.weights_max"))
    avg_deg = wg.m / max(wg.n, 1)
    delta = w_max / max(avg_deg, 1.0)
    return delta if delta > 0 else 1.0


def adaptive_delta(wg: WeightedCSRGraph, lanes: int | None = None):
    """Bucket width from the weight histogram: where the sorted log-weights
    have a gap of at least 4x with both sides holding at least 5 % of the
    edges, the geometric midpoint of the gap (if wider than
    ``default_delta``); otherwise ``default_delta``. With ``lanes``, a
    ``lanes``-tuple of that width (the engine takes per-lane widths)."""
    base = default_delta(wg)
    w = wg.weights.cpu().numpy().astype(np.float64).reshape(-1)
    w = w[np.isfinite(w) & (w > 0)]
    delta = base
    if w.size >= 2:
        logw = np.sort(np.log(w))
        gaps = np.diff(logw)
        k = int(np.argmax(gaps))
        heavy_frac = (logw.size - (k + 1)) / logw.size
        light_frac = (k + 1) / logw.size
        if (gaps[k] >= np.log(4.0) and heavy_frac >= 0.05
                and light_frac >= 0.05):
            mid = float(np.exp((logw[k] + logw[k + 1]) / 2.0))
            delta = max(base, mid)
    if lanes is None:
        return float(delta)
    return (float(delta),) * lanes


def _delta_lanes(delta, lanes: int) -> np.ndarray:
    """Per-lane bucket widths float32[L] from a scalar or a lanes-tuple."""
    if isinstance(delta, tuple):
        if len(delta) != lanes:
            raise ValueError(
                f"per-lane delta needs {lanes} entries, got {len(delta)}")
        return np.asarray(delta, np.float32)
    return np.full(lanes, np.float32(delta))


def _check_delta(delta) -> None:
    vals = delta if isinstance(delta, tuple) else (delta,)
    if len(vals) == 0 or not all(v > 0 for v in vals):
        raise ValueError(f"delta must be > 0, got {delta}")


def _as_roots(roots) -> np.ndarray:
    if isinstance(roots, torch.Tensor):
        roots = roots.cpu().numpy()
    return np.asarray(roots).astype(np.int32).reshape(-1)


def sssp_engine_init(wg: WeightedCSRGraph, capacity: int,
                     lanes: int = DEFAULT_LANES) -> SSSPState:
    """Fresh engine on the graph's device: all lanes idle, an empty source
    queue of ``capacity`` slots."""
    return fresh_sssp_state(wg.n, wg.device, capacity, lanes)


def fresh_sssp_state(n: int, dev, capacity: int, lanes: int, base: int = 0,
                     comm=None) -> SSSPState:
    """An idle engine whose row arrays hold ``n`` rows from global row
    ``base`` on ``dev``; a sharded one (``comm`` set) meters its
    exchanges."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    cap = capacity
    return SSSPState(
        dist=torch.full((n, lanes), INF, dtype=torch.float32, device=dev),
        relaxed=torch.zeros((n, lanes), dtype=torch.bool, device=dev),
        lane_bucket=np.zeros(lanes, np.int32),
        lane_steps=np.zeros(lanes, np.int32),
        lane_qidx=np.full(lanes, cap, np.int32),
        queue=np.zeros(cap, np.int32), queued=0, next_root=0, sweep_steps=0,
        out_dist=torch.full((n, cap + 1), INF, dtype=torch.float32,
                            device=dev),
        out_steps=np.zeros(cap + 1, np.int32),
        out_truncated=np.zeros(cap + 1, bool),
        trace_bucket=np.full((MAX_SSSP_TRACE, cap + 1), -1, np.int32),
        trace_phase=np.full((MAX_SSSP_TRACE, cap + 1), -1, np.int32),
        iterating=np.zeros(lanes, bool), phase_w={}, base=base, comm=comm,
        exch_log=None if comm is None else np.zeros(MAX_SSSP_TRACE,
                                                    np.int64))


def sssp_state_from_numpy(fields: dict, device=None) -> SSSPState:
    """A reference ``SSSPState``, given as numpy arrays and ints keyed by
    its field names, as a port state on ``device``: the state carried
    across, as ``pipeline_state_from_numpy`` carries the MS-BFS engine's.
    The lanes' phases are read on the first step."""
    device = resolve_device(device)

    def dev(name, dtype):
        return torch.from_numpy(np.array(fields[name], dtype=dtype)).to(
            device)

    def host(name, dtype=np.int32):
        return np.array(fields[name], dtype=dtype)

    return SSSPState(
        dist=dev("dist", np.float32), relaxed=dev("relaxed", bool),
        lane_bucket=host("lane_bucket"), lane_steps=host("lane_steps"),
        lane_qidx=host("lane_qidx"), queue=host("queue"),
        queued=int(fields["queued"]), next_root=int(fields["next_root"]),
        sweep_steps=int(fields["sweep_steps"]),
        out_dist=dev("out_dist", np.float32), out_steps=host("out_steps"),
        out_truncated=host("out_truncated", bool),
        trace_bucket=host("trace_bucket"), trace_phase=host("trace_phase"))


def sssp_engine_enqueue(state: SSSPState, roots) -> SSSPState:
    """Append sources to the pending queue (host only, mid-sweep safe); they
    land in idle lanes on the next ``sssp_engine_step``."""
    roots = _as_roots(roots)
    k = roots.shape[0]
    if state.queued + k > state.capacity:
        raise ValueError(
            f"queue overflow: {state.queued} queued + {k} new > capacity "
            f"{state.capacity}")
    queue = state.queue.copy()
    queue[state.queued:state.queued + k] = roots
    return state._replace(queue=queue, queued=state.queued + k)


def sssp_engine_idle(state: SSSPState) -> bool:
    """True when no lane is active and no enqueued source is pending."""
    return (state.next_root >= state.queued
            and not bool((state.lane_qidx < state.capacity).any()))


def _bucket_ceiling(lane_bucket: np.ndarray, lane_d: np.ndarray,
                    active: np.ndarray) -> np.ndarray:
    """float32[L] bucket ceilings ``(b + 1) * delta`` in float32, as the
    reference computes them; -inf for idle lanes, so that no vertex of an
    idle lane is a bucket member."""
    b_hi = (lane_bucket.astype(np.float32) + np.float32(1)) * lane_d
    return np.where(active, b_hi, np.float32(-np.inf)).astype(np.float32)


def _with_host_view(wg: WeightedCSRGraph, s: SSSPState,
                    lane_d: np.ndarray) -> SSSPState:
    """Fill in what a carried-in state lacks: the weight cache and the
    lanes' phases (one read-back, once)."""
    if s.phase_w is None:
        s = s._replace(phase_w={})
    if s.iterating is None:
        active = s.lane_qidx < s.capacity
        b_hi = to_device(_bucket_ceiling(s.lane_bucket, lane_d, active),
                         wg.device)
        pending = ((s.dist < b_hi) & ~s.relaxed).any(dim=0)
        s = s._replace(iterating=to_host(pending, "sssp.pending") & active)
    return s


def _refill(wg: WeightedCSRGraph, s: SSSPState,
            lane_d: np.ndarray) -> SSSPState:
    """Claim pending queue slots for idle lanes and seat their sources at
    distance 0, bucket 0. Idle lanes already hold inf distances and no
    relaxed flags, so seating writes one zero per claimed lane, in place,
    on the ranks that hold the source's row; a fresh lane iterates on its
    first step exactly when its source is a vertex of the (padded) graph
    (and its width is positive in float32)."""
    cap = s.capacity
    if not ((s.lane_qidx >= cap).any() and s.next_root < s.queued):
        return s
    claim, cand, root = queue_claims(s.lane_qidx, s.next_root, s.queued,
                                     s.queue)
    lanes = np.flatnonzero(claim)
    roots = root[lanes]
    rows = s.dist.shape[0]
    n = rows * (s.comm.pr if isinstance(s.comm, GridComm) else 1)
    keep = (roots >= 0) & (roots < n)
    own = keep & (roots >= s.base) & (roots < s.base + rows)
    if own.any():
        # through the flat index: an indexed assignment of a scalar would
        # make the host wait for the device
        flat = (roots[own] - s.base).astype(np.int64) * s.num_lanes \
            + lanes[own]
        s.dist.view(-1).index_fill_(0, to_device(flat, wg.device), 0.0)
    iterating = s.iterating.copy()
    iterating[lanes] = keep & (lane_d[lanes] > 0)
    return s._replace(
        lane_bucket=np.where(claim, 0, s.lane_bucket).astype(np.int32),
        lane_steps=np.where(claim, 0, s.lane_steps).astype(np.int32),
        lane_qidx=np.where(claim, cand, s.lane_qidx).astype(np.int32),
        next_root=s.next_root + int(claim.sum()), iterating=iterating)


def _phase_weights(wg: WeightedCSRGraph, s: SSSPState, dv: float):
    """(light, heavy) edge weights of bucket width ``dv``: ``w`` where
    ``w <= dv`` (resp. ``> dv``) in float32, +inf elsewhere; cached in the
    state, computed once per width."""
    if dv not in s.phase_w:
        d32 = float(np.float32(dv))
        w = wg.weights
        s.phase_w[dv] = (torch.where(w <= d32, w, INF),
                         torch.where(w > d32, w, INF))
    return s.phase_w[dv]


def _relax(wg: WeightedCSRGraph, weights: torch.Tensor, vals: torch.Tensor,
           max_pos: int, relax_impl: str) -> torch.Tensor:
    # on the card always the two kernels; the reference's two paths give
    # the same bits, so relax_impl only picks the plain path on the CPU
    impl = "pallas" if vals.is_cuda else relax_impl
    return tropical_relax(wg.csr, weights, vals, max_pos, impl)


def prepare_step(wg: WeightedCSRGraph, s: SSSPState, delta) -> SSSPState:
    """``s`` with its host view filled in and its idle lanes refilled: the
    state a step relaxes from. Preparing a prepared state changes
    nothing."""
    lane_d = _delta_lanes(delta, s.num_lanes)
    return _refill(wg, _with_host_view(wg, s, lane_d), lane_d)


class StepPlan(NamedTuple):
    """What a step decides before it relaxes (after the refill)."""
    lane_d: np.ndarray            # float32[L] bucket widths
    active: np.ndarray            # bool[L] lanes serving a source
    iterating: np.ndarray         # bool[L] lanes in the light phase
    settling: np.ndarray          # bool[L] lanes in the heavy phase
    b_hi: torch.Tensor            # float32[L] bucket ceilings (-inf idle)
    in_bucket: torch.Tensor       # bool[n, L] bucket members
    light_pending: torch.Tensor   # bool[n, L] members not yet relaxed


def plan_step(wg: WeightedCSRGraph, s: SSSPState, delta) -> StepPlan:
    """The phases and bucket masks of the step a prepared state ``s`` is
    about to take."""
    lane_d = _delta_lanes(delta, s.num_lanes)
    active = s.lane_qidx < s.capacity
    iterating = s.iterating & active
    # membership is ceiling-only (dist < (b+1)*delta), as in the reference:
    # settled vertices re-enter the mask, and their re-relaxations are
    # idempotent
    b_hi = to_device(_bucket_ceiling(s.lane_bucket, lane_d, active),
                     wg.device)
    in_bucket = s.dist < b_hi
    return StepPlan(lane_d, active, iterating, active & ~iterating, b_hi,
                    in_bucket, in_bucket & ~s.relaxed)


def phase_groups(wg: WeightedCSRGraph, s: SSSPState, delta, p: StepPlan):
    """Yield ``(phase, weights, on)`` for each masked relax of the step,
    ``on`` the bool[L] lanes (on the device) that take part.

    Lanes are grouped by distinct bucket width (the light/heavy split is
    per edge); each group runs a light relax (its iterating lanes over
    light weights) and a heavy one (its settling lanes over heavy
    weights), each skipped when no lane of the group is in that phase, as
    the reference's ``lax.cond`` skips them."""
    widths = (sorted(set(delta)) if isinstance(delta, tuple)
              else [float(delta)])
    lane_widths = (delta if isinstance(delta, tuple)
                   else (float(delta),) * s.num_lanes)
    for dv in widths:
        group = np.array([lw == dv for lw in lane_widths])
        light_w, heavy_w = _phase_weights(wg, s, dv)
        for phase, on, w in (("light", p.iterating & group, light_w),
                             ("heavy", p.settling & group, heavy_w)):
            if on.any():
                yield phase, w, to_device(on, wg.device)


def phase_inputs(wg: WeightedCSRGraph, s: SSSPState, delta, p: StepPlan):
    """Yield ``(phase, weights, vals)`` for each masked relax of the step
    (``phase_groups``): the light relax takes its lanes' pending members,
    the heavy one its lanes' bucket members, +inf elsewhere."""
    for phase, w, on in phase_groups(wg, s, delta, p):
        members = p.light_pending if phase == "light" else p.in_bucket
        yield phase, w, torch.where(members & on, s.dist, INF)


def source_values(s: SSSPState, p: StepPlan) -> torch.Tensor:
    """The union of every phase's source values: a lane is in one phase,
    so its pending members (light) or its bucket members (heavy) at their
    distance, +inf elsewhere. What a 2-D step ships, once."""
    members = torch.where(to_device(p.iterating, s.dist.device)[None, :],
                          p.light_pending, p.in_bucket)
    return torch.where(members, s.dist, INF)


def _sharded_candidates(wg: WeightedCSRGraph, s: SSSPState, delta,
                        p: StepPlan, max_pos: int, relax_impl: str,
                        compress: bool):
    """The step's candidate distances of the state's rows on a sharded
    state, and the exchange bytes of the step: a device int64 tensor whose
    sum is the bytes all ranks shipped.

    1-D: the phases relax the rank's block against the replicated values;
    the block's candidates, placed on an +inf background, are MIN-exchanged
    over the mesh (``exchange_reduce_min``). 2-D: the rank's chunk of the
    union source values (``source_values``) is gathered along "row" into
    the column block's slice ``x``, each phase relaxes the block against
    ``x`` masked to its lanes, and the partial candidates are MIN-folded
    along "col"."""
    rows, lanes, dev = s.dist.shape[0], s.num_lanes, wg.device
    grid = s.comm if isinstance(s.comm, GridComm) else None
    cand = torch.full((wg.n, lanes), INF, dtype=torch.float32, device=dev)
    if grid is None:
        for _, w, vals in phase_inputs(wg, s, delta, p):
            torch.minimum(cand, _relax(wg, w, vals, max_pos, relax_impl),
                          out=cand)
        placed = torch.full((rows, lanes), INF, dtype=torch.float32,
                            device=dev)
        # the ranks' blocks lie in mesh order (the values are replicated,
        # so the state's own rows start at 0)
        lo = s.comm.index * wg.n
        placed[lo:lo + wg.n] = cand
        cand, nbytes = exchange_reduce_min(placed, s.comm, compress)
        return cand, to_device(np.array([nbytes], np.int64), dev)
    chunk = rows // grid.pc
    x, b_expand = exchange_expand_values(
        source_values(s, p)[grid.j * chunk:(grid.j + 1) * chunk], grid.row,
        compress)
    for _, w, on in phase_groups(wg, s, delta, p):
        torch.minimum(cand, _relax(wg, w, torch.where(on, x, INF), max_pos,
                                   relax_impl), out=cand)
    cand, b_fold = exchange_reduce_min(cand, grid.col, compress)
    # each expand group's total once (grid row 0), each fold group's once
    # (grid column 0): the sum over the grid is the reference's psums
    sent = to_device(np.array([b_expand * (grid.i == 0),
                               b_fold * (grid.j == 0)], np.int64), dev)
    return cand, grid_sum(sent, grid)


def _sssp_body(wg: WeightedCSRGraph, s: SSSPState, delta, max_pos: int,
               relax_impl: str, max_steps: int,
               compress: bool = False) -> SSSPState:
    """One engine step: refill idle lanes, run the light/heavy phase each
    lane is in, advance settled buckets, flush finished lanes. Reads the
    device back once. ``wg`` is the graph, or the rank's block of it for a
    sharded state; ``compress`` ships a sharded step's exchanges through
    the sparse value codec."""
    with spans.span("sssp.step"):
        return _sssp_phases(wg, s, delta, max_pos, relax_impl, max_steps,
                            compress)


def _sssp_phases(wg: WeightedCSRGraph, s: SSSPState, delta, max_pos: int,
                 relax_impl: str, max_steps: int,
                 compress: bool) -> SSSPState:
    """``_sssp_body``'s step, one span a phase: the refill (prepare), the
    plan, the relaxes, the elementwise update, the read-back and the
    flush."""
    dev = wg.device
    cap = s.capacity
    with spans.span("sssp.prepare"):
        s = prepare_step(wg, s, delta)
    with spans.span("sssp.plan"):
        p = plan_step(wg, s, delta)
        lane_d, active, iterating, settling, b_hi = p[:5]
        spans.count_lanes(active)

    # every candidate folds into the new distances by min, which is exact
    # in any order
    with spans.span("sssp.relax"):
        sent = None
        if s.comm is None:
            new_dist = s.dist.clone()
            for _, w, vals in phase_inputs(wg, s, delta, p):
                torch.minimum(new_dist,
                              _relax(wg, w, vals, max_pos, relax_impl),
                              out=new_dist)
        else:
            cand, sent = _sharded_candidates(wg, s, delta, p, max_pos,
                                             relax_impl, compress)
            new_dist = torch.minimum(s.dist, cand)

    with spans.span("sssp.update"):
        changed = new_dist < s.dist
        # sources just relaxed are served at their distance; a vertex whose
        # distance improved re-enters its bucket's request set
        relaxed = (s.relaxed | (p.light_pending & to_device(iterating, dev))) \
            & ~changed

        # settling lanes jump to the bucket of their least unsettled
        # distance (empty buckets are never visited), at least one bucket
        # on. XLA compiles the reference's floor(min / delta) for a static
        # delta into floor(min * f32(1/delta)), so the port multiplies by
        # that reciprocal. The next bucket's request set is non-empty iff
        # the least distance not yet relaxed lies below its ceiling: it
        # decides whether the lane iterates on the next step, and is read
        # in the same read-back. On a grid both minima are taken over the
        # grid column's row blocks first.
        mins = torch.stack([
            torch.where(new_dist >= b_hi, new_dist, INF).amin(dim=0),
            torch.where(relaxed, INF, new_dist).amin(dim=0)])
        if isinstance(s.comm, GridComm):
            mins = pmin(mins, s.comm.row)
        mu, least_open = mins[0], mins[1]
        bucket = to_device(s.lane_bucket, dev)
        advance = to_device(settling, dev) & torch.isfinite(mu)
        recip = to_device(np.float32(1) / lane_d, dev)
        jump = torch.floor(torch.where(advance, mu, 0.0) * recip).to(
            torch.int32)
        next_bucket = torch.where(advance, torch.maximum(jump, bucket + 1),
                                  bucket)
        b_next = (next_bucket.to(torch.float32) + 1) * to_device(lane_d, dev)
        back = torch.stack([mu.view(torch.int32), next_bucket,
                            (least_open < b_next).to(torch.int32)]).reshape(-1)
        if sent is not None:     # a sharded step's bytes, in the same read
            back = torch.cat([back, sent.view(torch.int32)])
    back = to_host(back, "sssp.readback")

    with spans.span("sssp.flush"):
        nbytes = int(back[3 * s.num_lanes:].view(np.int64).sum())
        back = back[:3 * s.num_lanes].reshape(3, -1)
        mu_h, next_bucket = back[0].view(np.float32), back[1]

        exhausted = settling & ~np.isfinite(mu_h)
        lane_steps = (s.lane_steps + active).astype(np.int32)
        # a capped lane's distances are a partial relaxation: its flush is
        # marked truncated
        capped = active & (lane_steps >= max_steps) & ~exhausted
        finished = exhausted | capped

        # one trace row per engine step of the lane's root, in its output
        # column, so a finished lane's trace persists
        trace_bucket, trace_phase = (s.trace_bucket.copy(),
                                     s.trace_phase.copy())
        row = np.clip(s.lane_steps, 0, MAX_SSSP_TRACE - 1)[active]
        col = s.lane_qidx[active]
        trace_bucket[row, col] = s.lane_bucket[active]
        trace_phase[row, col] = np.where(iterating, 0, 1)[active]

        out_steps, out_truncated = s.out_steps, s.out_truncated
        done = np.flatnonzero(finished)
        if done.size:
            qidx = s.lane_qidx[done]
            out_steps, out_truncated = out_steps.copy(), out_truncated.copy()
            out_steps[qidx] = lane_steps[done]
            out_truncated[qidx] = capped[done]
            done_t = to_device(done, dev)
            s.out_dist.index_copy_(1, to_device(qidx.astype(np.int64), dev),
                                   new_dist.index_select(1, done_t))
            # retire the finished lanes, so _refill can seat a source there
            # on the very next step
            new_dist.index_fill_(1, done_t, INF)
            relaxed.index_fill_(1, done_t, False)
        exch_log = s.exch_log
        if exch_log is not None:
            exch_log = exch_log.copy()
            exch_log[min(s.sweep_steps, MAX_SSSP_TRACE - 1)] += nbytes
        return s._replace(
            dist=new_dist, relaxed=relaxed,
            lane_bucket=np.where(finished, 0, next_bucket).astype(np.int32),
            lane_steps=np.where(finished, 0, lane_steps).astype(np.int32),
            lane_qidx=np.where(finished, cap, s.lane_qidx).astype(np.int32),
            sweep_steps=s.sweep_steps + 1, out_steps=out_steps,
            out_truncated=out_truncated, trace_bucket=trace_bucket,
            trace_phase=trace_phase,
            iterating=back[2].astype(bool) & active & ~finished,
            exch_bytes=s.exch_bytes + nbytes, exch_log=exch_log)


def sssp_engine_step(wg: WeightedCSRGraph, state: SSSPState, delta,
                     max_pos: int = 8, relax_impl: str = "xla",
                     max_steps: int = MAX_SSSP_STEPS) -> SSSPState:
    """Advance the engine by one phase step (streaming API). ``delta`` is a
    scalar bucket width or a per-lane tuple. A step consumes the state it
    is given: device arrays may be updated in place, so keep stepping the
    state a step returns."""
    _check_delta(delta)
    return _sssp_body(wg, state, delta, max_pos, relax_impl, max_steps)


def sssp_engine_drain(wg: WeightedCSRGraph, state: SSSPState, delta,
                      max_pos: int = 8, relax_impl: str = "xla",
                      max_steps: int = MAX_SSSP_STEPS) -> SSSPState:
    """Step the engine until every enqueued source has been answered."""
    _check_delta(delta)
    with spans.span("sssp.drain"):
        while not sssp_engine_idle(state):
            state = _sssp_body(wg, state, delta, max_pos, relax_impl,
                               max_steps)
    return state


def sssp_engine_result(state: SSSPState) -> SSSPResult:
    """An ``SSSPResult`` over the enqueued queue slots, on the state's
    device (unanswered slots hold init values: inf distances, 0 steps).
    ``truncated`` lanes hit the step cap: their distances are partial."""
    r = state.queued
    dev = state.dist.device

    def up(a):
        return upload(a, dev, "sssp.upload")

    with spans.span("sssp.result"):
        return SSSPResult(sources=up(state.queue[:r]),
                          dist=state.out_dist[:, :r].contiguous(),
                          steps=up(state.out_steps[:r]),
                          truncated=up(state.out_truncated[:r]),
                          trace_bucket=up(state.trace_bucket[:, :r]),
                          trace_phase=up(state.trace_phase[:, :r]))


def sssp_pipelined(wg: WeightedCSRGraph, roots, delta=None,
                   lanes: int = DEFAULT_LANES, max_pos: int = 8,
                   relax_impl: str = "xla", max_steps: int = MAX_SSSP_STEPS,
                   recorder=None) -> SSSPResult:
    """Answer any number of SSSP sources in one pipelined sweep.

    Sources beyond the lane pool wait in the queue and stream into lanes as
    they free up. ``delta=None`` picks ``default_delta(wg)``; a per-lane
    tuple (length = the effective lane count, ``min(lanes, sources)``)
    gives each lane its own bucket width.

    ``recorder`` (a ``repro_torch.obs.SweepRecorder``) records a
    ``LayerRecord`` per engine step by stepping instead of the drain (the
    shared ``_sssp_body``: distances, steps and traces bit-identical);
    None (the default) runs no recorder. The phases' spans
    (``obs/spans.py``) record only while the torch profiler does."""
    roots = _as_roots(roots)
    num_roots = roots.shape[0]
    if num_roots < 1:
        raise ValueError("need at least one source")
    if delta is None:
        with spans.span("sssp.delta"):
            delta = default_delta(wg)
    lanes = max(1, min(lanes, num_roots))
    delta = delta if isinstance(delta, tuple) else float(delta)
    with spans.span("sssp.init"):
        state = sssp_engine_init(wg, capacity=num_roots, lanes=lanes)
        state = sssp_engine_enqueue(state, roots)
    if recorder is None:
        state = sssp_engine_drain(wg, state, delta, max_pos, relax_impl,
                                  max_steps)
    else:
        from repro_torch.obs.sweeplog import drive_recorded
        state = drive_recorded(
            recorder, state,
            lambda s: sssp_engine_step(wg, s, delta, max_pos, relax_impl,
                                       max_steps),
            sssp_engine_idle, kind="sssp")
    return sssp_engine_result(state)
