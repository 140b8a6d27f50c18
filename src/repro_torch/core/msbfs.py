"""Bit-packed multi-source BFS (MS-BFS): port of ``repro.core.msbfs``.

Independent BFS traversals run together, one bit-lane each: bit ``r %
LANE_WORD_BITS`` of lane word ``r // LANE_WORD_BITS`` at row ``v`` means
"root r's traversal has reached v" (``core/packed.py``; the words are 32 or
64 bits wide, ``word_dtype()``). Two engines share the packed steps:

* ``msbfs``: one batch of R <= ``MAX_LANES`` roots.
* the pipelined engine (``msbfs_pipelined`` and the ``msbfs_engine_*``
  stepping API): any number of roots streamed through a fixed pool of
  bit-lanes. A lane whose traversal ends (frontier empty, or the MAX_TRACE
  cap) is flushed to its output slot and refilled from the pending queue on
  the next step. Roots may be enqueued mid-sweep.

The reference runs each sweep as one on-device ``while_loop``; the port is
a host loop over layers. The big arrays (frontier and visited words, the
per-lane depths, the flushed depths) live on the device; the lane
bookkeeping, the queue and the per-root traces live on the host, where the
direction switch, the skips and the queue claims are decided. A layer reads
the device back once: the per-lane counters (e_f, v_f, e_u), which feed the
switch, the traces, the finish test and the traversed-edge count.

Parents are derived once at the end from the depths (min-id neighbour one
level up), which equals the serial ``bfs`` parents exactly.

The pipelined engine also runs sharded. On a 1-D partition
(``core/dist_msbfs.py``) a state whose ``comm`` names a mesh group holds the
rank's row block of the row-indexed arrays (from global row ``base``) and
the replicated frontier; the step runs the packed step on the rank's block
of the graph, gathers the ranks' new rows into the next frontier and sums
the counters over the ranks before the one read-back. On a 2-D grid
(``core/dist2d.py``, ``comm`` a ``GridComm``) the frontier is a row block
too: the step gathers the column block's frontier slice along "row", runs
the packed step on the rank's adjacency block against it, and OR-folds the
partial new rows along "col". Either way the host control is the same on
every rank.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.csr import CSRGraph
from repro_torch.core.exchange import (GridComm, all_gather, exchange_expand,
                                       exchange_reduce_or, grid_sum, psum)
from repro_torch.core.hybrid import ALPHA_DEFAULT, BETA_DEFAULT, MAX_TRACE
from repro_torch.core.packed import (LANE_WORD_BITS, MODES, depth_slice_words,
                                     dispatch_packed_step, host_word_dtype,
                                     lane_counters, num_lane_words,
                                     pack_lanes_np, queue_claims,
                                     select_direction, signed_words,
                                     to_device, to_host, unpack_lanes,
                                     upload, word_dtype)
from repro_torch.kernels.derive_parents.ops import derive_parents
from repro_torch.obs import spans

MAX_LANES = 64  # roots per batch: two 32-bit lane words, or one 64-bit


class MSBFSResult(NamedTuple):
    # All int32 on the graph's device, as in the reference.
    parent: torch.Tensor           # [n, R], -1 unreached, parent[root_r, r] = root_r
    depth: torch.Tensor            # [n, R], -1 unreached
    num_layers: torch.Tensor       # [R] layers until lane r's frontier emptied
    edges_traversed: torch.Tensor  # [R] 2x undirected component edges per lane
    trace_dir: torch.Tensor        # [MAX_TRACE, R]: 0 TD, 1 BU, -1 lane idle
    trace_vf: torch.Tensor         # [MAX_TRACE, R]
    trace_ef: torch.Tensor         # [MAX_TRACE, R]
    trace_eu: torch.Tensor         # [MAX_TRACE, R]

    def reached_words(self, max_depth=None, min_depth=0) -> torch.Tensor:
        """Packed lane words over the depth band [min_depth, max_depth]:
        with the defaults each lane's reached set, ``max_depth=k`` the k-hop
        neighbourhood, ``min_depth=max_depth=d`` the layer-d frontier."""
        if max_depth is None:
            max_depth = np.iinfo(np.int32).max
        return depth_slice_words(self.depth, max_depth, min_depth)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _as_roots(roots) -> np.ndarray:
    if isinstance(roots, torch.Tensor):
        roots = roots.cpu().numpy()
    return np.asarray(roots).astype(np.int32).reshape(-1)


def _seat_words(words: torch.Tensor, roots: np.ndarray,
                lanes: np.ndarray) -> np.ndarray:
    """Set bit ``lane`` of row ``root`` in ``words``, in place, for roots
    inside [0, n) (the reference's one-hot seat has no bit for others).
    Returns the host mask of the roots seated."""
    n = words.shape[0]
    keep = (roots >= 0) & (roots < n)
    roots, lanes = roots[keep].astype(np.int64), lanes[keep].astype(np.int64)
    dev = words.device
    if roots.size:
        key = roots * words.shape[1] + lanes // LANE_WORD_BITS
        uniq, inv = np.unique(key, return_inverse=True)
        bits = np.zeros(uniq.size, np.int64)
        np.bitwise_or.at(bits, inv, np.int64(1) << (lanes % LANE_WORD_BITS))
        idx = to_device(uniq, dev)
        flat = words.view(-1)
        flat.index_copy_(0, idx, flat.index_select(0, idx)
                         | to_device(signed_words(bits), dev))
    return keep


def _seat_depth(depth: torch.Tensor, rows: np.ndarray,
                lanes: np.ndarray) -> None:
    """Depth 0 at (row, lane), in place, through the flat index: an
    indexed assignment of a scalar would make the host wait for the
    device."""
    if rows.size:
        flat = rows.astype(np.int64) * depth.shape[1] + lanes
        depth.view(-1).index_fill_(0, to_device(flat, depth.device), 0)


def _seat(words: torch.Tensor, depth: torch.Tensor, roots: np.ndarray,
          lanes: np.ndarray) -> np.ndarray:
    """``_seat_words``, and depth 0 at (root, lane) for the roots seated."""
    keep = _seat_words(words, roots, lanes)
    _seat_depth(depth, roots[keep], lanes[keep])
    return keep


# ---------------------------------------------------------------------------
# Single-batch engine
# ---------------------------------------------------------------------------


def msbfs(g: CSRGraph, roots, mode: str = "hybrid",
          alpha: float = ALPHA_DEFAULT, beta: float = BETA_DEFAULT,
          max_pos: int = 8) -> MSBFSResult:
    """Run up to MAX_LANES BFS traversals together, one bit-lane each.

    ``roots`` holds R <= 64 root ids (any int array or tensor); ``mode`` is
    "hybrid" (per-lane alpha/beta switching), "topdown" or "bottomup". One
    host read-back per layer: the per-lane counters."""
    _check_mode(mode)
    roots = _as_roots(roots)
    num_roots = roots.shape[0]
    if num_roots > MAX_LANES:
        raise ValueError(f"at most {MAX_LANES} roots per batch, "
                         f"got {num_roots}: use msbfs_pipelined for "
                         f"arbitrary root counts")
    n, dev = g.n, g.device
    w = num_lane_words(num_roots)
    frontier = torch.zeros((n, w), dtype=word_dtype(), device=dev)
    depth = torch.full((n, num_roots), -1, dtype=torch.int32, device=dev)
    _seat(frontier, depth, roots, np.arange(num_roots))
    visited = frontier.clone()
    topdown = np.full(num_roots, mode != "bottomup")
    trace = np.zeros((4, MAX_TRACE, num_roots), np.int32)  # dir, vf, ef, eu
    trace[0] = -1
    layer = 0
    while layer < MAX_TRACE:
        e_f, v_f, e_u = torch.stack(lane_counters(
            g, unpack_lanes(frontier, num_roots),
            unpack_lanes(visited, num_roots))).cpu().numpy()
        if not v_f.any():
            break
        topdown = select_direction(mode, topdown, e_f, v_f, e_u, n, alpha,
                                   beta, num_roots)
        # dead lanes (empty frontier) leave both selectors and record
        # nothing: -1 direction and zero counters, as in the reference
        live = v_f > 0
        new = dispatch_packed_step(g, frontier, visited,
                                   pack_lanes_np(topdown & live),
                                   pack_lanes_np(~topdown & live), mode,
                                   max_pos)
        depth = torch.where(unpack_lanes(new, num_roots), layer + 1, depth)
        trace[:, layer] = np.where(live, [np.where(topdown, 0, 1), v_f, e_f,
                                          e_u], [[-1], [0], [0], [0]])
        frontier, visited = new, visited | new
        layer += 1
    deg = g.deg[:, None]
    edges = torch.where(unpack_lanes(visited, num_roots), deg, 0).sum(
        dim=0, dtype=torch.int32)
    # a cap-terminated lane ran exactly MAX_TRACE layers
    num_layers = (depth.max(dim=0).values + 1).clamp(max=MAX_TRACE)
    parent = _derive_parents(g, depth, roots)
    tr = torch.from_numpy(trace).to(dev)
    return MSBFSResult(parent=parent, depth=depth, num_layers=num_layers,
                       edges_traversed=edges, trace_dir=tr[0], trace_vf=tr[1],
                       trace_ef=tr[2], trace_eu=tr[3])


def _derive_parents(g: CSRGraph, depth: torch.Tensor, roots,
                    base: int = 0) -> torch.Tensor:
    """parent[v, r] = min-id neighbour of v one level up in lane r, for the
    rows [base, base + g.n) of the global ``depth`` [n, R]: the whole graph,
    or a rank's block of it (whose pad slots name the sentinel n and so
    never win).

    One op for every caller (``kernels/derive_parents``): on the card a
    kernel that narrows the depths to a byte a lane and scans each row's
    neighbours with a min per lane in registers; on the CPU the chunked
    plain version. Min-id matches the serial steps' deterministic
    scatter-min parent choice. A root is seated only in the rows that hold
    it."""
    with spans.span("msbfs.parents"):
        n_loc = g.n
        roots = _as_roots(roots)
        num_roots = roots.shape[0]
        parent = derive_parents(g.row_ptr, g.col_idx, g.src_idx, depth, base)
        with spans.span("parents.seat"):
            keep = (roots >= base) & (roots < base + n_loc)
            lanes = np.arange(num_roots)[keep]
            if lanes.size:
                parent[to_device((roots[keep] - base).astype(np.int64),
                                 g.device),
                       to_device(lanes, g.device)] = to_device(roots[keep],
                                                               g.device)
        return parent


# ---------------------------------------------------------------------------
# Pipelined engine: arbitrary root counts through a fixed bit-lane pool.
#
# Invariants (kept by _refill and the step):
#   * lane_qidx[l] < capacity  <=>  lane l serves queue slot lane_qidx[l];
#     idle lanes hold lane_qidx == capacity, all-zero frontier and visited
#     bits and an all -1 depth column.
#   * queue[:queued] holds the enqueued roots; slots [next_root, queued) are
#     pending. A claimed slot is served by one lane until its traversal
#     ends, then flushed to column lane_qidx[l] of the out_* arrays.
#   * out_layers[q] > 0  <=>  query q has been answered (flushed).
#   * counters[:, l] are lane l's (e_f, v_f, e_u) for the state as it
#     stands; idle lanes hold (0, 0, sum of degrees).
# The out_* arrays keep the reference's trailing column (index capacity),
# where the reference scatters the rows of lanes that did not finish. The
# port writes only the lanes that do, so that column is never written, and
# columns [0, capacity) equal the reference's.
# A sharded state (comm set) holds rows [base, base + n_loc) of visited,
# depth and out_depth, and the whole frontier on a 1-D partition or the same
# rows of it on a 2-D grid; the counters, the degrees and all host control
# are global and the same on every rank.
# ---------------------------------------------------------------------------


class PipelineState(NamedTuple):
    frontier: torch.Tensor       # word_dtype()[n, W]  packed lane frontiers (device)
    visited: torch.Tensor        # word_dtype()[n, W]  (device)
    depth: torch.Tensor          # int32[n, L]  active-lane depths (device)
    lane_layer: np.ndarray       # int32[L]     steps run for the lane's root
    lane_qidx: np.ndarray        # int32[L]     queue slot served; capacity = idle
    topdown: np.ndarray          # bool[L]
    queue: np.ndarray            # int32[capacity] enqueued root ids
    queued: int                  # roots enqueued
    next_root: int               # next queue slot to claim
    sweep_layers: int            # engine steps run
    out_depth: torch.Tensor      # int32[n, capacity+1]  (device)
    out_edges: np.ndarray        # int32[capacity+1]
    out_layers: np.ndarray       # int32[capacity+1]  0 = unanswered
    trace_dir: np.ndarray        # int32[MAX_TRACE, capacity+1]
    trace_vf: np.ndarray
    trace_ef: np.ndarray
    trace_eu: np.ndarray
    counters: np.ndarray | None = None  # int32[3, L] (e_f, v_f, e_u); None = not read yet
    deg: np.ndarray | None = None       # host int32[n] degrees; None = not read yet
    deg_total: int = 0                  # sum of deg (an idle lane's e_u)
    base: int = 0                       # global row of visited/depth row 0
    comm: object = None                 # MeshComm (1-D) or GridComm (2-D); None = one device
    exch_bytes: int = 0                 # wire bytes of the 2-D exchanges, all ranks
    exch_log: np.ndarray | None = None  # int64[MAX_TRACE] bytes per step; None = not metered

    @property
    def num_lanes(self) -> int:
        return self.lane_qidx.shape[0]

    @property
    def capacity(self) -> int:
        return self.queue.shape[0]


def msbfs_engine_init(g: CSRGraph, capacity: int,
                      lanes: int = MAX_LANES) -> PipelineState:
    """Fresh engine on the graph's device: all lanes idle, an empty root
    queue of ``capacity`` slots, ``lanes`` bit-lanes (W =
    ceil(lanes / LANE_WORD_BITS) lane words per vertex)."""
    return _fresh_state(to_host(g.deg, "msbfs.degrees"), g.n, g.device,
                        capacity, lanes)


def _fresh_state(deg: np.ndarray, n_loc: int, dev, capacity: int,
                 lanes: int, base: int = 0, comm=None,
                 frontier_rows: int | None = None) -> PipelineState:
    """An idle engine over the host degrees ``deg`` [n] whose row arrays
    hold ``n_loc`` rows from global row ``base`` (all n on one device), and
    whose frontier holds ``frontier_rows`` rows (default n; n_loc on a 2-D
    grid, where the frontier is a row block too)."""
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    if lanes < 1:
        raise ValueError(f"lanes must be >= 1, got {lanes}")
    n, cap, w = deg.shape[0], capacity, num_lane_words(lanes)
    deg_total = int(deg.sum(dtype=np.int64))
    counters = np.zeros((3, lanes), np.int32)
    counters[2] = deg_total
    return PipelineState(
        frontier=torch.zeros((n if frontier_rows is None else frontier_rows,
                              w), dtype=word_dtype(), device=dev),
        visited=torch.zeros((n_loc, w), dtype=word_dtype(), device=dev),
        depth=torch.full((n_loc, lanes), -1, dtype=torch.int32, device=dev),
        lane_layer=np.zeros(lanes, np.int32),
        lane_qidx=np.full(lanes, cap, np.int32),
        topdown=np.ones(lanes, bool),
        queue=np.zeros(cap, np.int32), queued=0, next_root=0, sweep_layers=0,
        out_depth=torch.full((n_loc, cap + 1), -1, dtype=torch.int32,
                             device=dev),
        out_edges=np.zeros(cap + 1, np.int32),
        out_layers=np.zeros(cap + 1, np.int32),
        trace_dir=np.full((MAX_TRACE, cap + 1), -1, np.int32),
        trace_vf=np.zeros((MAX_TRACE, cap + 1), np.int32),
        trace_ef=np.zeros((MAX_TRACE, cap + 1), np.int32),
        trace_eu=np.zeros((MAX_TRACE, cap + 1), np.int32),
        counters=counters, deg=deg, deg_total=deg_total, base=base,
        comm=comm)


def pipeline_state_from_numpy(fields: dict, device=None) -> PipelineState:
    """A reference ``PipelineState``, given as numpy arrays and ints keyed
    by its field names (lane words unsigned, as the reference holds them,
    or as their signed view), as a port state on ``device``: the state
    carried across, as ``core/csr.py::from_numpy_graph`` carries the graph.
    The counters and the host degrees are read on the first step."""
    from repro_torch.device import resolve_device
    device = resolve_device(device)

    def dev(name, words=False):
        a = np.ascontiguousarray(fields[name])
        a = signed_words(a) if words else a.astype(np.int32)
        return torch.from_numpy(a).to(device)

    def host(name, dtype=np.int32):
        return np.array(fields[name], dtype=dtype)

    return PipelineState(
        frontier=dev("frontier", True), visited=dev("visited", True),
        depth=dev("depth"),
        lane_layer=host("lane_layer"), lane_qidx=host("lane_qidx"),
        topdown=host("topdown", bool), queue=host("queue"),
        queued=int(fields["queued"]), next_root=int(fields["next_root"]),
        sweep_layers=int(fields["sweep_layers"]),
        out_depth=dev("out_depth"), out_edges=host("out_edges"),
        out_layers=host("out_layers"), trace_dir=host("trace_dir"),
        trace_vf=host("trace_vf"), trace_ef=host("trace_ef"),
        trace_eu=host("trace_eu"))


def _with_host_view(g: CSRGraph, s: PipelineState) -> PipelineState:
    """Fill in the host degrees and the counters where a carried-in state
    lacks them (one read-back, once)."""
    if s.deg is None:
        deg = to_host(g.deg, "msbfs.degrees")
        s = s._replace(deg=deg, deg_total=int(deg.sum(dtype=np.int64)))
    if s.counters is None:
        lanes = s.num_lanes
        s = s._replace(counters=to_host(torch.stack(lane_counters(
            g, unpack_lanes(s.frontier, lanes),
            unpack_lanes(s.visited, lanes))), "msbfs.readback"))
    return s


def _idle_counters(counters: np.ndarray, deg_total: int,
                   lanes: np.ndarray) -> np.ndarray:
    """``counters`` with ``lanes`` set to an idle lane's (0, 0, sum of
    degrees)."""
    counters = counters.copy()
    counters[:2, lanes] = 0
    counters[2, lanes] = deg_total
    return counters


def _global_rows(s: PipelineState, rows: torch.Tensor) -> torch.Tensor:
    """A row-indexed device array of the state in global row order: the
    array itself on one device, the ranks' blocks gathered in mesh order on
    a mesh, the row blocks gathered along "row" on a grid (a
    collective)."""
    if s.comm is None:
        return rows
    comm = s.comm.row if isinstance(s.comm, GridComm) else s.comm
    if rows.shape[1] == 0:
        return rows.new_zeros((comm.size * rows.shape[0], 0))
    return all_gather(rows.contiguous(), comm).reshape(-1, rows.shape[1])


def msbfs_engine_enqueue(state: PipelineState, roots) -> PipelineState:
    """Append roots to the pending queue (host only, mid-sweep safe); they
    land in idle lanes on the next ``msbfs_engine_step``."""
    roots = _as_roots(roots)
    k = roots.shape[0]
    if state.queued + k > state.capacity:
        raise ValueError(
            f"queue overflow: {state.queued} queued + {k} new > capacity "
            f"{state.capacity}")
    queue = state.queue.copy()
    queue[state.queued:state.queued + k] = roots
    return state._replace(queue=queue, queued=state.queued + k)


def msbfs_engine_idle(state: PipelineState) -> bool:
    """True when no lane is active and no enqueued root is pending."""
    return (state.next_root >= state.queued
            and not bool((state.lane_qidx < state.capacity).any()))


def _refill(g: CSRGraph, s: PipelineState,
            topdown_init: bool) -> PipelineState:
    """Claim pending queue slots for idle lanes and seat their roots.

    Idle lanes have zero bits and -1 depths, so seating sets one bit and
    one depth per claimed lane: the frontier bit on every rank that holds
    the root's frontier row, the depth on the root's owner. A root is
    seated when it is a vertex of the (padded) graph. Nothing is done when
    no lane is idle or no root is pending."""
    cap = s.capacity
    if not ((s.lane_qidx >= cap).any() and s.next_root < s.queued):
        return s
    claim, cand, root = queue_claims(s.lane_qidx, s.next_root, s.queued,
                                     s.queue)
    lanes = np.flatnonzero(claim)
    roots = root[lanes]
    seated = (roots >= 0) & (roots < s.deg.shape[0])
    # the frontier holds every row, or on a 2-D grid the rank's rows
    f0 = 0 if s.frontier.shape[0] == s.deg.shape[0] else s.base
    _seat_words(s.frontier, roots - f0, lanes)
    rows = slice(s.base, s.base + s.depth.shape[0])
    own = seated & (roots >= rows.start) & (roots < rows.stop)
    _seat_depth(s.depth, roots[own] - rows.start, lanes[own])
    # frontier is inside visited, so this adds exactly the fresh bits
    visited = s.visited | s.frontier[rows.start - f0:rows.stop - f0]
    counters = _idle_counters(s.counters, s.deg_total, lanes)
    d = s.deg[roots[seated]]
    counters[0, lanes[seated]] = d
    counters[1, lanes[seated]] = 1
    counters[2, lanes[seated]] -= d
    return s._replace(
        visited=visited,
        lane_layer=np.where(claim, 0, s.lane_layer).astype(np.int32),
        lane_qidx=np.where(claim, cand, s.lane_qidx).astype(np.int32),
        topdown=np.where(claim, topdown_init, s.topdown),
        next_root=s.next_root + int(claim.sum()), counters=counters)


def _plan(s: PipelineState, mode: str, n: int, alpha: float, beta: float):
    """The layer's per-lane direction and live lanes, from the counters of
    the state as it stands (after the refill): host bool[L] (topdown, live).
    The top-down lanes are ``topdown & live``, the bottom-up ones
    ``~topdown & live``."""
    e_f, v_f, e_u = s.counters
    topdown = select_direction(mode, s.topdown, e_f, v_f, e_u, n, alpha,
                               beta, s.num_lanes)
    return topdown, (s.lane_qidx < s.capacity) & (v_f > 0)


def _pipeline_body(g: CSRGraph, s: PipelineState, mode: str, alpha: float,
                   beta: float, max_pos: int, n: int | None = None,
                   compress: bool = False) -> PipelineState:
    """One engine step: refill idle lanes, advance one layer, flush the
    lanes that finished. Reads the device back once, for the counters of
    the new state. ``g`` is the graph, or the rank's block of it for a
    sharded state, whose new rows are gathered into the next frontier (on
    a 2-D grid: whose frontier slice is gathered first, and whose partial
    rows are OR-folded) and whose counters are summed over the ranks. ``n``
    is the vertex count of the switch rule (default ``g.n``); ``compress``
    ships the 2-D exchanges through the sparse word codec."""
    with spans.span("msbfs.step"):
        return _pipeline_phases(g, s, mode, alpha, beta, max_pos, n,
                                compress)


def _pipeline_phases(g: CSRGraph, s: PipelineState, mode: str, alpha: float,
                     beta: float, max_pos: int, n: int | None,
                     compress: bool) -> PipelineState:
    """``_pipeline_body``'s step, one span a phase: the refill, the plan,
    the packed step (the dispatch), the lane counters, the read-back and
    the flush."""
    n = g.n if n is None else n
    dev = g.device
    lanes = s.num_lanes
    cap = s.capacity
    with spans.span("msbfs.refill"):
        s = _refill(g, _with_host_view(g, s), mode != "bottomup")

    with spans.span("msbfs.plan"):
        active = s.lane_qidx < cap
        e_f, v_f, e_u = s.counters
        topdown, live = _plan(s, mode, n, alpha, beta)
        spans.count_lanes(live)

        # per-root trace rows are indexed by the lane's own layer counter
        # and its queue slot, so a root's trace replays its serial run
        # whichever lane served it and whenever it was claimed
        trace = [t.copy() for t in (s.trace_dir, s.trace_vf, s.trace_ef,
                                    s.trace_eu)]
        row = np.clip(s.lane_layer, 0, MAX_TRACE - 1)[active]
        col = s.lane_qidx[active]
        for t, vals in zip(trace, (np.where(live, np.where(topdown, 0, 1),
                                            -1), v_f, e_f, e_u)):
            t[row, col] = vals[active]

    with spans.span("msbfs.dispatch"):
        grid = s.comm if isinstance(s.comm, GridComm) else None
        frontier = s.frontier
        if grid is not None:
            # expand: each rank of the grid column gives its own chunk of
            # the row block, which make up this column block's frontier
            # slice x_j
            chunk = s.frontier.shape[0] // grid.pc
            frontier, b_expand = exchange_expand(
                s.frontier[grid.j * chunk:(grid.j + 1) * chunk], grid.row,
                compress)
        new = dispatch_packed_step(g, frontier, s.visited,
                                   pack_lanes_np(topdown & live),
                                   pack_lanes_np(~topdown & live), mode,
                                   max_pos)
        if grid is not None:
            # fold: the partial rows of the grid row's blocks make the row
            # block's new frontier
            new, b_fold = exchange_reduce_or(new, grid.col, compress)

    with spans.span("msbfs.counters"):
        new_b = unpack_lanes(new, lanes)
        visited2 = s.visited | new
        lane_layer2 = (s.lane_layer + active).astype(np.int32)
        depth2 = torch.where(new_b, to_device(lane_layer2, dev)[None, :],
                             s.depth)
        counters = torch.stack(lane_counters(
            g, new_b, unpack_lanes(visited2, lanes)))
        nbytes = 0
        if grid is not None:
            frontier = new
            # block degrees are partial, so e_f and e_u sum over the whole
            # grid; a row block's vertices count once (grid column 0), as
            # does each expand group's byte total (grid row 0) and each
            # fold group's (grid column 0): one all-reduce gives the
            # reference's psums over its axes
            mask = to_device(np.array([1, grid.j == 0, 1], np.int64), dev)
            sent = to_device(np.array([b_expand * (grid.i == 0),
                                       b_fold * (grid.j == 0)], np.int64),
                             dev)
            counters = grid_sum(torch.cat([(counters.long() * mask[:, None])
                                           .reshape(-1), sent]), grid)
        else:
            # on a mesh the ranks own disjoint rows: their new rows in mesh
            # order are the next frontier, and the counters are the ranks'
            # sums
            frontier = _global_rows(s, new)
            if s.comm is not None:
                counters = psum(counters, s.comm)
    counters = to_host(counters, "msbfs.readback")

    with spans.span("msbfs.flush"):
        if grid is not None:
            counters, nbytes = (counters[:-2].reshape(3, lanes)
                                .astype(np.int32), int(counters[-2:].sum()))
        exch_log = s.exch_log
        if exch_log is not None:
            exch_log = exch_log.copy()
            exch_log[min(s.sweep_layers, MAX_TRACE - 1)] += nbytes

        # finish = frontier drained or the per-lane layer cap (the serial
        # loop bound, and what makes the drain terminate)
        finished = active & ((counters[1] == 0) | (lane_layer2 >= MAX_TRACE))
        out_edges, out_layers = s.out_edges, s.out_layers
        done = np.flatnonzero(finished)
        if done.size:
            qidx = s.lane_qidx[done]
            out_edges, out_layers = out_edges.copy(), out_layers.copy()
            # visited2's edge count is the sum of degrees less e_u
            out_edges[qidx] = s.deg_total - counters[2, done]
            out_layers[qidx] = lane_layer2[done]
            done_t = to_device(done, dev)
            s.out_depth.index_copy_(1, to_device(qidx.astype(np.int64), dev),
                                    depth2.index_select(1, done_t))
            # retire the finished lanes: zero their bits and depths so that
            # _refill can seat a fresh root on the very next step
            clear = to_device(~pack_lanes_np(finished), dev)
            frontier, visited2 = frontier & clear, visited2 & clear
            depth2.index_fill_(1, done_t, -1)
            counters = _idle_counters(counters, s.deg_total, done)
        return s._replace(
            frontier=frontier, visited=visited2, depth=depth2,
            lane_layer=np.where(finished, 0, lane_layer2).astype(np.int32),
            lane_qidx=np.where(finished, cap, s.lane_qidx).astype(np.int32),
            topdown=topdown, sweep_layers=s.sweep_layers + 1,
            out_edges=out_edges, out_layers=out_layers, trace_dir=trace[0],
            trace_vf=trace[1], trace_ef=trace[2], trace_eu=trace[3],
            counters=counters, exch_bytes=s.exch_bytes + nbytes,
            exch_log=exch_log)


def msbfs_engine_step(g: CSRGraph, state: PipelineState,
                      mode: str = "hybrid", alpha: float = ALPHA_DEFAULT,
                      beta: float = BETA_DEFAULT,
                      max_pos: int = 8) -> PipelineState:
    """Advance the pipelined engine by one traversal layer (streaming API).

    A step consumes the state it is given: device arrays may be updated in
    place, so keep stepping the state a step returns."""
    _check_mode(mode)
    return _pipeline_body(g, state, mode, alpha, beta, max_pos)


def msbfs_engine_drain(g: CSRGraph, state: PipelineState,
                       mode: str = "hybrid", alpha: float = ALPHA_DEFAULT,
                       beta: float = BETA_DEFAULT,
                       max_pos: int = 8) -> PipelineState:
    """Step the engine until every enqueued root has been answered."""
    _check_mode(mode)
    with spans.span("msbfs.drain"):
        while not msbfs_engine_idle(state):
            state = _pipeline_body(g, state, mode, alpha, beta, max_pos)
    return state


def msbfs_engine_result(g: CSRGraph, state: PipelineState,
                        derive_parents: bool = True) -> MSBFSResult:
    """An ``MSBFSResult`` over the enqueued queue slots, on the graph's
    device. Columns of unanswered slots (``out_layers == 0``) hold init
    values; callers normally drain first. ``derive_parents=False`` returns
    a zero-width ``parent``. A sharded state's rows are gathered into
    global order (every rank calls it, with its block of the graph)."""
    r = state.queued
    dev = g.device
    depth = _global_rows(state, state.out_depth[:, :r].contiguous())
    parent = (_global_rows(state, _derive_parents(
                  g, depth, state.queue[:r], state.base)) if derive_parents
              else torch.zeros((depth.shape[0], 0), dtype=torch.int32,
                               device=dev))

    def up(a):
        return upload(a[..., :r], dev, "msbfs.upload")

    with spans.span("msbfs.result"):
        return MSBFSResult(
            parent=parent, depth=depth, num_layers=up(state.out_layers),
            edges_traversed=up(state.out_edges),
            trace_dir=up(state.trace_dir), trace_vf=up(state.trace_vf),
            trace_ef=up(state.trace_ef), trace_eu=up(state.trace_eu))


# ---------------------------------------------------------------------------
# Mid-sweep read-out. Once a lane has run t layers, its depths <= t are
# final, so a depth-k query is answerable as soon as the lane's layer
# counter passes k; ``msbfs_engine_retire`` then flushes the lane early.
# ---------------------------------------------------------------------------


class LayerReadout(NamedTuple):
    """Host snapshot of the engine's per-lane depth surface after a step."""
    layer: int                   # total engine steps run (sweep clock)
    capacity: int                # queue capacity (lane_qidx == capacity = idle)
    lane_qidx: np.ndarray        # int32[L] queue slot served per lane
    lane_layer: np.ndarray       # int32[L] layers run for the lane's root
    depth: np.ndarray            # int32[n, L] live per-lane depths
    out_depth: np.ndarray        # int32[n, capacity+1] flushed columns
    out_layers: np.ndarray       # int32[capacity+1]  0 = unanswered

    def active(self) -> np.ndarray:
        """bool[L]: lane currently serving a queue slot."""
        return self.lane_qidx < self.capacity

    def band_final(self, k: int) -> np.ndarray:
        """bool[L]: active lane whose ``depth <= k`` band is final."""
        return self.active() & (self.lane_layer >= k)

    def lane_of_slot(self, q: int) -> int:
        """Lane currently serving queue slot ``q`` (-1 if none)."""
        hit = np.flatnonzero(self.lane_qidx == q)
        return int(hit[0]) if hit.size else -1

    def slot_depth(self, q: int) -> np.ndarray | None:
        """Depth column of queue slot ``q``: the flushed column once
        answered, the live lane column while in flight, None before the
        root is seated."""
        if self.out_layers[q] > 0:
            return self.out_depth[:, q]
        lane = self.lane_of_slot(q)
        return self.depth[:, lane] if lane >= 0 else None

    def slice_words(self, max_depth: int, min_depth: int = 0) -> np.ndarray:
        """``packed.depth_slice_words`` over the live lane depths, as
        unsigned words (the reference's dtype, ``host_word_dtype()``)."""
        words = depth_slice_words(torch.from_numpy(self.depth), max_depth,
                                  min_depth)
        return words.numpy().view(host_word_dtype())


def msbfs_engine_readout(state: PipelineState) -> LayerReadout:
    """Snapshot the streaming read-out surface (host copies; a sharded
    state's rows gathered into global order, on every rank)."""
    return LayerReadout(
        layer=state.sweep_layers, capacity=state.capacity,
        lane_qidx=state.lane_qidx.copy(), lane_layer=state.lane_layer.copy(),
        depth=_global_rows(state, state.depth).to("cpu", copy=True).numpy(),
        out_depth=_global_rows(state, state.out_depth).to(
            "cpu", copy=True).numpy(),
        out_layers=state.out_layers.copy())


def msbfs_engine_stream(g: CSRGraph, state: PipelineState,
                        mode: str = "hybrid", alpha: float = ALPHA_DEFAULT,
                        beta: float = BETA_DEFAULT, max_pos: int = 8):
    """Step the engine to idleness, yielding ``(state, LayerReadout)``
    after every layer. The caller may enqueue or retire between yields;
    idleness is checked against the state last yielded, so keep stepping
    that state."""
    while not msbfs_engine_idle(state):
        state = msbfs_engine_step(g, state, mode, alpha, beta, max_pos)
        yield state, msbfs_engine_readout(state)


def msbfs_engine_retire(g: CSRGraph, state: PipelineState,
                        lane_mask) -> PipelineState:
    """Retire the masked ACTIVE lanes early: flush their depth columns to
    their output slots as they stand and free the lanes for the pending
    queue. ``out_layers`` records the layers run (at least 1, the answered
    flag). Idle lanes in the mask are ignored."""
    lane_mask = np.asarray(lane_mask, bool).reshape(-1)
    if lane_mask.shape[0] != state.num_lanes:
        raise ValueError(
            f"lane_mask has {lane_mask.shape[0]} lanes, engine has "
            f"{state.num_lanes}")
    s = _with_host_view(g, state)
    cap = s.capacity
    mask = lane_mask & (s.lane_qidx < cap)
    lanes = np.flatnonzero(mask)
    if not lanes.size:
        return s
    dev = g.device
    qidx = s.lane_qidx[lanes]
    out_edges, out_layers = s.out_edges.copy(), s.out_layers.copy()
    out_edges[qidx] = s.deg_total - s.counters[2, lanes]
    out_layers[qidx] = np.maximum(s.lane_layer[lanes], 1)
    lanes_t = to_device(lanes, dev)
    s.out_depth.index_copy_(1, to_device(qidx.astype(np.int64), dev),
                            s.depth.index_select(1, lanes_t))
    clear = to_device(~pack_lanes_np(mask), dev)
    depth = s.depth.index_fill(1, lanes_t, -1)
    return s._replace(
        frontier=s.frontier & clear, visited=s.visited & clear, depth=depth,
        lane_layer=np.where(mask, 0, s.lane_layer).astype(np.int32),
        lane_qidx=np.where(mask, cap, s.lane_qidx).astype(np.int32),
        out_edges=out_edges, out_layers=out_layers,
        counters=_idle_counters(s.counters, s.deg_total, lanes))


def msbfs_pipelined(g: CSRGraph, roots, mode: str = "hybrid",
                    alpha: float = ALPHA_DEFAULT, beta: float = BETA_DEFAULT,
                    max_pos: int = 8, lanes: int = MAX_LANES,
                    derive_parents: bool = True,
                    recorder=None) -> MSBFSResult:
    """Answer any number of roots in one pipelined engine sweep.

    Roots beyond the ``lanes`` pool wait in the queue and refill lanes as
    traversals finish, with no batch barrier. With R <= lanes the pool
    shrinks to R rounded up to whole lane words, and this gives the
    single-batch ``msbfs`` results.

    ``recorder`` (a ``repro_torch.obs.SweepRecorder``) steps the engine
    through ``obs.sweeplog.drive_recorded`` and records a ``LayerRecord``
    per layer; the step and the drain share ``_pipeline_body``, so results
    and traces are bit-identical either way. With ``recorder=None`` (the
    default) no recorder runs. The phases' spans (``obs/spans.py``) record
    only while the torch profiler does."""
    _check_mode(mode)
    roots = _as_roots(roots)
    num_roots = roots.shape[0]
    if num_roots < 1:
        raise ValueError("need at least one root")
    lanes = max(1, min(lanes, LANE_WORD_BITS * num_lane_words(num_roots)))
    with spans.span("msbfs.init"):
        state = msbfs_engine_init(g, capacity=num_roots, lanes=lanes)
        state = msbfs_engine_enqueue(state, roots)
    if recorder is None:
        state = msbfs_engine_drain(g, state, mode, alpha, beta, max_pos)
    else:
        from repro_torch.obs.sweeplog import drive_recorded
        state = drive_recorded(
            recorder, state,
            lambda s: msbfs_engine_step(g, s, mode, alpha, beta, max_pos),
            msbfs_engine_idle, kind="bfs")
    return msbfs_engine_result(g, state, derive_parents=derive_parents)
