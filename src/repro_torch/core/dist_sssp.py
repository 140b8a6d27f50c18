"""Distributed delta-stepping SSSP: the tropical lane engine sharded (port of
``repro.core.dist_sssp`` on ``torch.distributed``).

The weighted sibling of ``dist_msbfs`` and ``dist2d``: float lane values
fold under MIN across partitions as packed words fold under OR, so both
partition shapes ride the MIN side of the shared exchange layer
(``core/exchange.py``: ``exchange_reduce_min``, ``exchange_expand_values``)
and its density-switched value codec: a relaxation candidate is ``inf``
wherever no relaxation fired this step, so compressed steps cost bytes in
proportion to the active frontier.

**1-D engine** (``dist_sssp_*``): rank d holds a contiguous row block of
the weighted CSR (``partition_weighted_graph``: ``dist_bfs``'s partition
and an inf-padded weight slab). The lane distances, the request flags and
all bucket control are replicated; per step each rank runs the host
engine's masked light/heavy relaxations (``traversal/sssp.py``,
``semiring.tropical_relax``, so the ``semiring_relax`` and
``relax_fallback`` kernels on the GPU) over its block against the whole
replicated values, places its block's candidates on an ``inf`` background,
and one ``exchange_reduce_min`` over the mesh completes them, as the
reference does. The bucket control reads the replicated distances, so it
is the host engine's on every rank.

**2-D engine** (``dist2d_sssp_*``): the ``pr x pc`` grid of ``dist2d``,
with no replicated ``[n, L]`` value state. Rank ``(i, j)`` holds row block
``i``'s distances (the same along "col") and the weighted adjacency block
``(i, j)``. Per step: take the own chunk of the masked source values,
gather it along "row" (``exchange_expand_values``) into the column block's
value slice, relax the local block, MIN-fold the partials along "col"
(``exchange_reduce_min``). A lane is in one phase at a time, so one masked
source array ships per step, and each rank recovers the light and heavy
operands from the per-lane phase flags after the gather. The least
unsettled and least unrelaxed distances are MIN-reduced along "row" before
the read-back, so every control decision is the host engine's.

Both engines are the host engine's step (``traversal/sssp.py::_sssp_body``)
on a state whose ``comm`` names the partition's groups: distances, step
counts, truncation flags and the bucket and phase traces equal
``sssp_pipelined``'s bit for bit. Both meter their exchange bytes
(``exch_bytes``, ``exch_log``) as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.csr import WeightedCSRGraph
from repro_torch.core.dist2d import (DistGraph2D, _check_partition_2d,
                                     _split_2d, mesh2d, partition_graph_2d)
from repro_torch.core.dist_bfs import mesh_device, partition_graph
from repro_torch.core.dist_msbfs import host_mesh
from repro_torch.core.exchange import (all_gather, allreduce_min, grid_comm,
                                       mesh_comm)
from repro_torch.traversal.sssp import (DEFAULT_LANES, MAX_SSSP_STEPS,
                                        SSSPResult, SSSPState, _as_roots,
                                        _check_delta, _sssp_body,
                                        fresh_sssp_state,
                                        sssp_engine_enqueue, sssp_engine_idle,
                                        sssp_engine_result)

__all__ = [
    "DistSSSPState", "DistWeightedGraph", "DistWeightedGraph2D",
    "allreduce_min", "default_delta_dist", "dist2d_sssp",
    "dist2d_sssp_engine_drain", "dist2d_sssp_engine_enqueue",
    "dist2d_sssp_engine_idle", "dist2d_sssp_engine_init",
    "dist2d_sssp_engine_result", "dist2d_sssp_engine_step", "dist_sssp",
    "dist_sssp_engine_drain", "dist_sssp_engine_enqueue",
    "dist_sssp_engine_idle", "dist_sssp_engine_init",
    "dist_sssp_engine_result", "dist_sssp_engine_step", "host_mesh",
    "mesh2d", "partition_weighted_graph", "partition_weighted_graph_2d",
]


def _weighted_block(row_ptr, col_idx, src_idx, weights, index, device):
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a[index])).to(device)
    return WeightedCSRGraph(row_ptr=put(row_ptr), col_idx=put(col_idx),
                            src_idx=put(src_idx), weights=put(weights))


# ---------------------------------------------------------------------------
# Weighted partitions: the unweighted structure and an inf-padded weight slab
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DistWeightedGraph:
    """A 1-D ``DistGraph`` and the matching per-block weight slabs (host
    numpy). Slab d is row block d's edges in adjacency order, so its
    weights are the same contiguous cut of ``wg.weights``; pad slots carry
    ``inf``, the min-plus annihilator."""
    row_ptr: np.ndarray   # int32[ndev, n_loc+1]
    col_idx: np.ndarray   # int32[ndev, m_loc], global neighbour ids (pad: n)
    src_loc: np.ndarray   # int32[ndev, m_loc]
    deg: np.ndarray       # int32[ndev, n_loc]
    weights: np.ndarray   # float32[ndev, m_loc], inf pads
    n: int                # padded global vertex count
    n_orig: int           # original vertex count
    m_loc: int            # uniform per-block edge-slab size
    _blocks: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def ndev(self) -> int:
        return self.row_ptr.shape[0]

    @property
    def n_loc(self) -> int:
        return self.n // self.ndev

    def local(self, index: int, device) -> WeightedCSRGraph:
        """Block ``index`` on ``device``, moved there once and cached."""
        key = (index, str(torch.device(device)))
        if key not in self._blocks:
            self._blocks[key] = _weighted_block(
                self.row_ptr, self.col_idx, self.src_loc, self.weights,
                index, device)
        return self._blocks[key]


def partition_weighted_graph(wg: WeightedCSRGraph,
                             ndev: int) -> DistWeightedGraph:
    """1-D partition of a weighted CSR: ``dist_bfs.partition_graph`` on the
    structure, and the weight slabs it implies."""
    dg = partition_graph(wg.csr, ndev)
    rp = wg.row_ptr.cpu().numpy()
    w = wg.weights.cpu().numpy()
    w_l = np.full((ndev, dg.m_loc), np.inf, np.float32)
    for d in range(ndev):
        lo_v, hi_v = d * dg.n_loc, min((d + 1) * dg.n_loc, wg.n)
        if lo_v < wg.n:
            slab = w[rp[lo_v]:rp[hi_v]]
            w_l[d, :len(slab)] = slab
    return DistWeightedGraph(row_ptr=dg.row_ptr, col_idx=dg.col_idx,
                             src_loc=dg.src_loc, deg=dg.deg, weights=w_l,
                             n=dg.n, n_orig=dg.n_orig, m_loc=dg.m_loc)


@dataclass(frozen=True)
class DistWeightedGraph2D:
    """A ``DistGraph2D`` and its per-block weight slabs (host numpy, inf
    pads). The structure is ``partition_graph_2d``'s; the weights follow
    the same per-block edge selection."""
    g2: DistGraph2D
    weights: np.ndarray   # float32[G, m_loc], inf pads
    _blocks: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n(self) -> int:
        return self.g2.n

    @property
    def n_orig(self) -> int:
        return self.g2.n_orig

    def local(self, index: int, device) -> WeightedCSRGraph:
        """Block ``index`` (``i*pc + j``) on ``device``: column ids local to
        the column block. Moved there once and cached."""
        key = (index, str(torch.device(device)))
        if key not in self._blocks:
            g2 = self.g2
            self._blocks[key] = _weighted_block(
                g2.row_ptr, g2.col_loc, g2.src_loc, self.weights, index,
                device)
        return self._blocks[key]


def partition_weighted_graph_2d(wg: WeightedCSRGraph, pr: int,
                                pc: int) -> DistWeightedGraph2D:
    """2-D partition of a weighted CSR: the structure from
    ``partition_graph_2d``, the weight slabs from the same cut (row block,
    destination filter and order)."""
    g2 = partition_graph_2d(wg.csr, pr, pc)
    _, cuts = _split_2d(wg.csr, pr, pc)
    w = wg.weights.cpu().numpy()
    w_l = np.full((pr * pc, g2.m_loc), np.inf, np.float32)
    for d, (lo, src, sel) in enumerate(cuts):
        slab = w[lo:lo + len(src)][sel]
        if len(slab) != int(g2.row_ptr[d, -1]):
            raise AssertionError(
                f"weight slab {d} selected {len(slab)} edges but the "
                f"structure partition holds {int(g2.row_ptr[d, -1])}")
        w_l[d, :len(slab)] = slab
    return DistWeightedGraph2D(g2=g2, weights=w_l)


def default_delta_dist(dwg) -> float:
    """``sssp.default_delta`` recomputed from a partitioned weighted graph:
    the same max-weight over average-degree rule over the real edges (pads
    are inf), the same value as the host's, so ``delta=None`` replays the
    host engine."""
    w = dwg.weights
    fin = np.isfinite(w)
    m = int(fin.sum())
    if m == 0:
        return 1.0
    w_max = float(w[fin].max())
    avg_deg = m / max(dwg.n_orig, 1)
    delta = w_max / max(avg_deg, 1.0)
    return delta if delta > 0 else 1.0


# The host engine's state serves both sharded engines: ``comm`` names the
# partition's groups, and ``exch_bytes`` / ``exch_log`` meter the exchanges.
# On the 1-D partition the row arrays hold every row (replicated), on the
# 2-D grid the rank's row block (from global row ``base``).
DistSSSPState = SSSPState


def _sweep(init, step, idle, result, roots, delta, lanes: int, recorder,
           compress: bool) -> SSSPResult:
    """The sweep shared by ``dist_sssp`` and ``dist2d_sssp``."""
    roots = _as_roots(roots)
    num_roots = roots.shape[0]
    if num_roots < 1:
        raise ValueError("need at least one source")
    lanes = max(1, min(lanes, num_roots))
    delta = delta if isinstance(delta, tuple) else float(delta)
    state = sssp_engine_enqueue(init(num_roots, lanes), roots)
    if recorder is None:
        while not sssp_engine_idle(state):
            state = step(state, delta)
    else:
        from repro_torch.obs.sweeplog import drive_recorded
        state = drive_recorded(
            recorder, state, lambda s: step(s, delta), sssp_engine_idle,
            kind="sssp", exch_format="compressed" if compress else "dense")
    return result(state)


# ---------------------------------------------------------------------------
# 1-D engine: replicated values, sharded graph, MIN-exchanged candidates
# ---------------------------------------------------------------------------


def _check_partition_1d(dwg: DistWeightedGraph, mesh) -> int:
    ndev = mesh.mesh.numel()
    if dwg.ndev != ndev:
        raise ValueError(
            f"DistWeightedGraph partitioned for {dwg.ndev} devices but mesh "
            f"has {ndev}: repartition with partition_weighted_graph(wg, "
            f"{ndev})")
    return ndev


def dist_sssp_engine_init(dwg: DistWeightedGraph, mesh, capacity: int,
                          lanes: int = DEFAULT_LANES) -> DistSSSPState:
    """Fresh sharded SSSP engine on this rank's device: all lanes idle, an
    empty source queue, byte meters at 0."""
    _check_partition_1d(dwg, mesh)
    return fresh_sssp_state(dwg.n, mesh_device(mesh), capacity, lanes,
                            comm=mesh_comm(mesh))


# the queue and the lanes are host state, the same on every rank
dist_sssp_engine_enqueue = sssp_engine_enqueue
dist_sssp_engine_idle = sssp_engine_idle


def dist_sssp_engine_step(dwg: DistWeightedGraph, state: DistSSSPState,
                          mesh, delta, max_pos: int = 8,
                          relax_impl: str = "xla",
                          max_steps: int = MAX_SSSP_STEPS,
                          compress: bool = False) -> DistSSSPState:
    """Advance the sharded engine by one phase step on every rank
    (streaming API). ``delta`` is a scalar or a per-lane tuple. A step
    consumes the state it is given: keep stepping the state it returns."""
    _check_delta(delta)
    _check_partition_1d(dwg, mesh)
    wg = dwg.local(state.comm.index, state.dist.device)
    return _sssp_body(wg, state, delta, max_pos, relax_impl, max_steps,
                      compress)


def dist_sssp_engine_drain(dwg: DistWeightedGraph, state: DistSSSPState,
                           mesh, delta, max_pos: int = 8,
                           relax_impl: str = "xla",
                           max_steps: int = MAX_SSSP_STEPS,
                           compress: bool = False) -> DistSSSPState:
    """Step the sharded engine until every enqueued source is answered."""
    while not sssp_engine_idle(state):
        state = dist_sssp_engine_step(dwg, state, mesh, delta, max_pos,
                                      relax_impl, max_steps, compress)
    return state


def dist_sssp_engine_result(dwg: DistWeightedGraph,
                            state: DistSSSPState) -> SSSPResult:
    """An ``SSSPResult`` over the enqueued queue slots, trimmed to the
    original vertex count (the distances are replicated)."""
    res = sssp_engine_result(state)
    return res._replace(dist=res.dist[:dwg.n_orig])


def dist_sssp(dwg: DistWeightedGraph, roots, mesh, delta=None,
              lanes: int = DEFAULT_LANES, max_pos: int = 8,
              relax_impl: str = "xla", max_steps: int = MAX_SSSP_STEPS,
              compress: bool = False, recorder=None) -> SSSPResult:
    """Answer any number of SSSP sources in one sharded sweep, on every
    rank of ``mesh``. ``delta=None`` takes the host's ``default_delta``
    (recomputed from the partition); distances, steps, truncation flags
    and traces equal ``sssp_pipelined``'s. ``recorder`` (a
    ``repro_torch.obs.SweepRecorder``) records a ``LayerRecord`` per step,
    with its exchange bytes; None runs no recorder."""
    if delta is None:
        delta = default_delta_dist(dwg)
    return _sweep(
        lambda cap, lanes: dist_sssp_engine_init(dwg, mesh, cap, lanes),
        lambda s, d: dist_sssp_engine_step(dwg, s, mesh, d, max_pos,
                                           relax_impl, max_steps, compress),
        sssp_engine_idle, lambda s: dist_sssp_engine_result(dwg, s), roots,
        delta, lanes, recorder, compress)


# ---------------------------------------------------------------------------
# 2-D engine: row-block values, expand / fold grid exchanges, MIN monoid
# ---------------------------------------------------------------------------


def _block_2d(dwg2: DistWeightedGraph2D, state: DistSSSPState):
    return dwg2.local(state.comm.i * dwg2.g2.pc + state.comm.j,
                      state.dist.device)


def dist2d_sssp_engine_init(dwg2: DistWeightedGraph2D, mesh, capacity: int,
                            lanes: int = DEFAULT_LANES) -> DistSSSPState:
    """Fresh 2-D SSSP engine on this rank's device: row-block value state,
    byte meters at 0."""
    g2 = dwg2.g2
    _check_partition_2d(g2, mesh)
    grid = grid_comm(mesh)
    return fresh_sssp_state(g2.n_loc_r, mesh_device(mesh), capacity, lanes,
                            base=grid.i * g2.n_loc_r, comm=grid)


dist2d_sssp_engine_enqueue = sssp_engine_enqueue
dist2d_sssp_engine_idle = sssp_engine_idle


def dist2d_sssp_engine_step(dwg2: DistWeightedGraph2D, state: DistSSSPState,
                            mesh, delta, max_pos: int = 8,
                            relax_impl: str = "xla",
                            max_steps: int = MAX_SSSP_STEPS,
                            compress: bool = False) -> DistSSSPState:
    """Advance the 2-D SSSP engine by one phase step on every rank
    (streaming API)."""
    _check_delta(delta)
    _check_partition_2d(dwg2.g2, mesh)
    return _sssp_body(_block_2d(dwg2, state), state, delta, max_pos,
                      relax_impl, max_steps, compress)


def dist2d_sssp_engine_drain(dwg2: DistWeightedGraph2D, state: DistSSSPState,
                             mesh, delta, max_pos: int = 8,
                             relax_impl: str = "xla",
                             max_steps: int = MAX_SSSP_STEPS,
                             compress: bool = False) -> DistSSSPState:
    """Step the 2-D engine until every enqueued source is answered."""
    while not sssp_engine_idle(state):
        state = dist2d_sssp_engine_step(dwg2, state, mesh, delta, max_pos,
                                        relax_impl, max_steps, compress)
    return state


def dist2d_sssp_engine_result(dwg2: DistWeightedGraph2D,
                              state: DistSSSPState) -> SSSPResult:
    """An ``SSSPResult`` on every rank: the row blocks of the distances
    gathered along "row" in global order, trimmed to the original vertex
    count. Collective."""
    res = sssp_engine_result(state)
    dist = all_gather(res.dist, state.comm.row).reshape(-1, res.dist.shape[1])
    return res._replace(dist=dist[:dwg2.n_orig])


def dist2d_sssp(dwg2: DistWeightedGraph2D, roots, mesh, delta=None,
                lanes: int = DEFAULT_LANES, max_pos: int = 8,
                relax_impl: str = "xla", max_steps: int = MAX_SSSP_STEPS,
                compress: bool = False, recorder=None) -> SSSPResult:
    """Answer any number of SSSP sources in one 2-D grid sweep, on every
    rank of the grid ``mesh``. ``compress=True`` ships both per-step value
    exchanges through the sparse codec whenever the gather group is below
    the density threshold; the results are the same either way.
    ``recorder`` records a ``LayerRecord`` per phase step, as in the other
    engines."""
    if delta is None:
        delta = default_delta_dist(dwg2)
    return _sweep(
        lambda cap, lanes: dist2d_sssp_engine_init(dwg2, mesh, cap, lanes),
        lambda s, d: dist2d_sssp_engine_step(dwg2, s, mesh, d, max_pos,
                                             relax_impl, max_steps,
                                             compress),
        sssp_engine_idle, lambda s: dist2d_sssp_engine_result(dwg2, s),
        roots, delta, lanes, recorder, compress)
