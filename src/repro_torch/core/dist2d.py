"""2-D partitioned multi-source BFS: the bit-lane engine on a pr x pc grid
(port of ``repro.core.dist2d`` on ``torch.distributed``).

The Buluc-Madduri (arXiv 1104.4518) 2-D decomposition applied to the packed
lane words. Where the 1-D engine (``core/dist_msbfs.py``) replicates the
whole ``[n, W]`` frontier on every rank, the 2-D engine partitions the
adjacency matrix over a ``pr x pc`` grid of ranks and holds no replicated
global frontier:

* vertices are cut into ``G = pr * pc`` equal chunks (each a multiple of
  32 rows); grid rank ``(i, j)`` owns chunk ``g = i*pc + j``;
* row block ``i`` is chunks ``[i*pc, (i+1)*pc)``, a contiguous global row
  range of ``n_loc_r = pc * chunk`` vertices, so results assemble by
  concatenation, as on the 1-D partition;
* column block ``j`` is chunks ``{i*pc + j}``, one chunk per grid row;
* rank ``(i, j)`` holds the CSR rows of row block ``i`` restricted to the
  destinations in column block ``j`` (``partition_graph_2d``), with column
  ids rewritten to positions in the column block.

Per layer, on rank ``(i, j)`` (the host engine's step, ``core/msbfs.py``,
on a state whose ``comm`` is a ``GridComm``):

  expand  all-gather the ``chunk x W`` frontier chunks along "row"
          (``exchange_expand``): the ranks of grid column ``j`` assemble
          ``x_j``, column block ``j``'s frontier slice, ``[n_x, W]``;
  step    the packed step (``core/packed.py``: ``segment_or`` top-down,
          ``msbfs_probe`` and the ``segment_or`` fallback bottom-up) over
          the local block against ``x_j``, giving partial new-frontier
          words of row block ``i`` (this block's edges only);
  fold    OR-fold the partials along "col" (``exchange_reduce_or``): grid
          row ``i`` assembles row block ``i``'s new frontier, the state the
          next layer's expand takes its chunk from.

Both exchanges ride ``core/exchange.py::gather_words`` and so the sparse
word codec: with ``compress=True`` a gather group ships (index, word) pairs
whenever every member's slice is sparse enough, and the bytes of a layer
follow the frontier population. The engine meters them (``exch_bytes``,
``exch_log``), as the reference does; a compressed exchange reads its
group's counts on the host, one sync more per exchange.

The step computes, for every local row, the OR of its block neighbours'
frontier words masked by ``need``; partial-row ORs over the grid columns
compose to the whole row's OR, the direction switch reads counters summed
over the grid, and all control is host state, the same on every rank. So
depths, parents, layer counts and per-layer traces are the host engine's
bit for bit.

Per-rank state: ``frontier``, ``visited`` ``word_dtype()[n_loc_r, W]``,
``depth`` ``int32[n_loc_r, L]`` and ``out_depth`` ``int32[n_loc_r,
capacity+1]``, the rows of row block ``i`` (the same on every rank of grid
row ``i``); everything else is host state. The only gathered state is
``x_j``, ``[n_x, W]`` with ``n_x = pr * chunk``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.csr import CSRGraph
from repro_torch.core.dist_bfs import mesh_device
from repro_torch.core.dist_msbfs import group_mesh
from repro_torch.core.exchange import GridComm, all_gather, grid_comm, pmin
from repro_torch.core.hybrid import ALPHA_DEFAULT, BETA_DEFAULT, MAX_TRACE
from repro_torch.core.msbfs import (MAX_LANES, MSBFSResult, PipelineState,
                                    _as_roots, _check_mode, _derive_parents,
                                    _fresh_state, _pipeline_body,
                                    msbfs_engine_enqueue, msbfs_engine_idle,
                                    msbfs_engine_result)
from repro_torch.core.packed import (LANE_WORD_BITS, adaptive_lane_pool,
                                     num_lane_words)

__all__ = [
    "DistGraph2D", "Dist2DPipelineState", "dist2d_msbfs",
    "dist2d_msbfs_engine_drain", "dist2d_msbfs_engine_enqueue",
    "dist2d_msbfs_engine_idle", "dist2d_msbfs_engine_init",
    "dist2d_msbfs_engine_result", "dist2d_msbfs_engine_step", "mesh2d",
    "partition_graph_2d",
]


class Block2D(NamedTuple):
    """One rank's adjacency block of a ``DistGraph2D`` on its device."""
    g: CSRGraph            # row_ptr [n_loc_r+1], col_idx = col_loc, src_loc
    col_gid: torch.Tensor  # int32[m_loc] global destination ids (pad: n)
    base: int              # first global row of the row block


@dataclass(frozen=True)
class DistGraph2D:
    """Host-partitioned 2-D CSR: stacked per-rank numpy blocks, leading dim
    ``G = pr * pc`` in grid-row-major order (rank ``(i, j)`` holds block
    ``i*pc + j``)."""
    row_ptr: np.ndarray   # int32[G, n_loc_r+1], offsets into the slab
    col_loc: np.ndarray   # int32[G, m_loc], column-block-local ids (pad: n_x)
    col_gid: np.ndarray   # int32[G, m_loc], global ids (pad: n)
    src_loc: np.ndarray   # int32[G, m_loc], row-block-local source row
    deg: np.ndarray       # int32[G, n_loc_r], partial (block) degrees
    n: int                # padded global vertex count (G * chunk)
    n_orig: int           # original vertex count
    pr: int               # grid rows
    pc: int               # grid columns
    chunk: int            # rows per chunk (a multiple of 32)
    m_loc: int            # uniform per-block edge-slab size (padded)
    _blocks: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_loc_r(self) -> int:
        """Rows per row block (``pc * chunk``)."""
        return self.pc * self.chunk

    @property
    def n_x(self) -> int:
        """Rows of a column block's frontier slice (``pr * chunk``)."""
        return self.pr * self.chunk

    def global_deg(self) -> np.ndarray:
        """int32[n] degrees: each row's partial degrees summed over its row
        block's column blocks."""
        return self.deg.reshape(self.pr, self.pc, self.n_loc_r).sum(
            axis=1, dtype=np.int32).reshape(-1)

    def local(self, index: int, device) -> Block2D:
        """Block ``index`` (``i*pc + j``) on ``device``, moved there once
        and cached."""
        device = torch.device(device)
        key = (index, str(device))
        if key not in self._blocks:
            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a[index])).to(
                    device)
            self._blocks[key] = Block2D(
                g=CSRGraph(row_ptr=put(self.row_ptr),
                           col_idx=put(self.col_loc),
                           src_idx=put(self.src_loc)),
                col_gid=put(self.col_gid),
                base=(index // self.pc) * self.n_loc_r)
        return self._blocks[key]


def _split_2d(g: CSRGraph, pr: int, pc: int):
    """The 2-D cut of ``g``'s edge slots: ``(chunk, [(lo, src, sel)])``
    with, for each block ``i*pc + j`` in order, row block ``i``'s first
    slot ``lo``, the local source row of each of its slots, and the mask
    ``sel`` of the slots whose destination chunk lies in column block
    ``j``, in adjacency order. Shared by the unweighted and the weighted
    partition."""
    if pr < 1 or pc < 1:
        raise ValueError(f"grid dims must be >= 1, got {pr}x{pc}")
    rp = g.row_ptr.cpu().numpy()
    ci = g.col_idx.cpu().numpy()
    chunk = -(-g.n // (pr * pc * 32)) * 32      # a multiple of 32
    n_loc_r = pc * chunk
    cuts = []
    for i in range(pr):
        lo_v, hi_v = i * n_loc_r, min((i + 1) * n_loc_r, g.n)
        lo, hi = (int(rp[lo_v]), int(rp[hi_v])) if lo_v < g.n else (0, 0)
        src = np.repeat(np.arange(max(hi_v - lo_v, 0), dtype=np.int32),
                        np.diff(rp[lo_v:hi_v + 1]))
        dst_chunk = ci[lo:hi] // chunk
        cuts += [(lo, src, dst_chunk % pc == j) for j in range(pc)]
    return chunk, cuts


def partition_graph_2d(g: CSRGraph, pr: int, pc: int) -> DistGraph2D:
    """Host-side 2-D partition of ``g`` into ``pr x pc`` adjacency blocks
    with uniform padding.

    Row blocks are contiguous global row ranges; in block ``(i, j)`` each
    row keeps the edges whose destination chunk ``v // chunk`` lies in
    column block ``j`` (chunk index ``% pc == j``), in adjacency order.
    ``col_loc`` rewrites a destination to its row in the column block's
    frontier slice (``grid_row * chunk + v % chunk``); ``col_gid`` keeps
    the global id, for the parents. Pad slots carry the ids ``n_x`` (local)
    and ``n`` (global) and lie past every row's slots."""
    chunk, cuts = _split_2d(g, pr, pc)
    ci = g.col_idx.cpu().numpy()
    ndev, n_loc_r, n_x = pr * pc, pc * chunk, pr * chunk
    n = chunk * ndev
    slabs = []
    for lo, src, sel in cuts:
        dst = ci[lo:lo + len(src)][sel]
        slabs.append(((dst // chunk // pc) * chunk + dst % chunk, dst,
                      src[sel]))
    m_loc = max(1, max(len(s[2]) for s in slabs))
    col_loc = np.full((ndev, m_loc), n_x, np.int32)
    col_gid = np.full((ndev, m_loc), n, np.int32)
    src_l = np.zeros((ndev, m_loc), np.int32)
    deg_l = np.stack([np.bincount(s[2], minlength=n_loc_r) for s in slabs]
                     ).astype(np.int32)
    row_ptr_l = np.zeros((ndev, n_loc_r + 1), np.int32)
    np.cumsum(deg_l, axis=1, out=row_ptr_l[:, 1:])
    for d, (loc, gid, src) in enumerate(slabs):
        col_loc[d, :len(src)] = loc
        col_gid[d, :len(src)] = gid
        src_l[d, :len(src)] = src
    return DistGraph2D(row_ptr=row_ptr_l, col_loc=col_loc, col_gid=col_gid,
                       src_loc=src_l, deg=deg_l, n=n, n_orig=g.n, pr=pr,
                       pc=pc, chunk=chunk, m_loc=m_loc)


# The host engine's state serves the 2-D engine: its row-indexed arrays,
# the frontier among them, hold the rank's row block (from global row
# ``base``), ``comm`` is the grid's ``GridComm``, the degrees and counters
# are global, and ``exch_bytes`` / ``exch_log`` meter the exchanges.
Dist2DPipelineState = PipelineState


def _check_partition_2d(dg: DistGraph2D, mesh) -> None:
    names = tuple(mesh.mesh_dim_names or ())
    if names != ("row", "col"):
        raise ValueError(
            f'the 2-D engine needs a ("row", "col") mesh, got axes {names}; '
            f"build one with mesh2d(pr, pc)")
    shape = tuple(mesh.mesh.shape)
    if shape != (dg.pr, dg.pc):
        raise ValueError(
            f"DistGraph2D partitioned for a {dg.pr}x{dg.pc} grid but the "
            f"mesh is {shape[0]}x{shape[1]}: repartition with "
            f"partition_graph_2d(g, {shape[0]}, {shape[1]})")


def mesh2d(pr: int, pc: int, device=None):
    """A ``pr x pc`` ``("row", "col")`` mesh over the initialised process
    group, which must have ``pr * pc`` ranks: on the GPU for
    ``device=None`` (NCCL, each rank on its ``cuda:<local rank>``), on the
    CPU for ``device="cpu"`` (gloo). Raises without a group, with another
    world size, or with the other device's backend, and says how to
    launch."""
    if pr < 1 or pc < 1:
        raise ValueError(f"grid dims must be >= 1, got {pr}x{pc}")
    return group_mesh(f"mesh2d({pr}, {pc})", (pr, pc), ("row", "col"),
                      device)


def _block(dg: DistGraph2D, grid: GridComm, device) -> Block2D:
    return dg.local(grid.i * dg.pc + grid.j, device)


def dist2d_msbfs_engine_init(dg: DistGraph2D, mesh, capacity: int,
                             lanes: int = MAX_LANES) -> Dist2DPipelineState:
    """Fresh 2-D engine on this rank's device: all lanes idle, an empty root
    queue of ``capacity`` slots, byte meters at 0."""
    _check_partition_2d(dg, mesh)
    grid = grid_comm(mesh)
    blk = _block(dg, grid, mesh_device(mesh))
    s = _fresh_state(dg.global_deg(), dg.n_loc_r, blk.g.device, capacity,
                     lanes, base=blk.base, comm=grid,
                     frontier_rows=dg.n_loc_r)
    return s._replace(exch_log=np.zeros(MAX_TRACE, np.int64))


# the queue and the lanes are host state, the same on every rank
dist2d_msbfs_engine_enqueue = msbfs_engine_enqueue
dist2d_msbfs_engine_idle = msbfs_engine_idle


def dist2d_msbfs_engine_step(dg: DistGraph2D, state: Dist2DPipelineState,
                             mesh, mode: str = "hybrid",
                             alpha: float = ALPHA_DEFAULT,
                             beta: float = BETA_DEFAULT, max_pos: int = 8,
                             compress: bool = False) -> Dist2DPipelineState:
    """Advance the 2-D engine by one traversal layer on every rank
    (streaming API). A step consumes the state it is given: keep stepping
    the state a step returns."""
    _check_mode(mode)
    _check_partition_2d(dg, mesh)
    g = _block(dg, state.comm, state.frontier.device).g
    return _pipeline_body(g, state, mode, alpha, beta, max_pos,
                          n=dg.n_orig, compress=compress)


def dist2d_msbfs_engine_drain(dg: DistGraph2D, state: Dist2DPipelineState,
                              mesh, mode: str = "hybrid",
                              alpha: float = ALPHA_DEFAULT,
                              beta: float = BETA_DEFAULT, max_pos: int = 8,
                              compress: bool = False) -> Dist2DPipelineState:
    """Step the 2-D engine until every enqueued root has been answered."""
    _check_mode(mode)
    _check_partition_2d(dg, mesh)
    g = _block(dg, state.comm, state.frontier.device).g
    while not msbfs_engine_idle(state):
        state = _pipeline_body(g, state, mode, alpha, beta, max_pos,
                               n=dg.n_orig, compress=compress)
    return state


def _derive_parents_2d(blk: Block2D, grid: GridComm, depth: torch.Tensor,
                       roots: np.ndarray, n: int) -> torch.Tensor:
    """Parents on the grid: each rank derives the min-id neighbour one
    level up over its block (global ids, ``col_gid``), grid row ``i`` takes
    the MIN of its column blocks' partials, and the row blocks are gathered
    along "row". The min-id winner over a row's whole adjacency is the min
    over its column blocks, so the parents are the host engine's."""
    g = CSRGraph(row_ptr=blk.g.row_ptr, col_idx=blk.col_gid,
                 src_idx=blk.g.src_idx)
    part = _derive_parents(g, depth, roots, blk.base)
    # no parent is -1 in a partial and must lose the MIN: n for the fold
    part = pmin(torch.where(part < 0, n, part), grid.col)
    part = torch.where(part < n, part, -1).to(torch.int32)
    return all_gather(part, grid.row).reshape(-1, part.shape[1])


def dist2d_msbfs_engine_result(dg: DistGraph2D, state: Dist2DPipelineState,
                               mesh, trim: bool = True,
                               derive_parents: bool = True) -> MSBFSResult:
    """An ``MSBFSResult`` over the enqueued queue slots on this rank's
    device, the same on every rank: the row blocks of the depths gathered
    in global order and the parents derived on the grid
    (``derive_parents=False`` gives a zero-width ``parent``). With ``trim``
    the rows are cut back to the original vertex count. Collective."""
    _check_partition_2d(dg, mesh)
    grid = state.comm
    blk = _block(dg, grid, state.frontier.device)
    res = msbfs_engine_result(blk.g, state, derive_parents=False)
    r = state.queued
    if r and derive_parents:
        res = res._replace(parent=_derive_parents_2d(
            blk, grid, res.depth, state.queue[:r], dg.n))
    lim = dg.n_orig if trim else dg.n
    return res._replace(parent=res.parent[:lim], depth=res.depth[:lim])


def dist2d_msbfs(dg: DistGraph2D, roots, mesh, mode: str = "hybrid",
                 alpha: float = ALPHA_DEFAULT, beta: float = BETA_DEFAULT,
                 max_pos: int = 8, lanes: int | None = None,
                 compress: bool = False, derive_parents: bool = True,
                 recorder=None) -> MSBFSResult:
    """Answer any number of roots in one 2-D engine sweep, on every rank of
    the grid ``mesh``.

    ``compress=True`` ships both per-layer exchanges through the sparse
    word codec whenever the gather group is below the density threshold;
    the results are the same either way. ``lanes=None`` (or 0) sizes the
    pool adaptively, as the other engines do. ``recorder`` (a
    ``repro_torch.obs.SweepRecorder``) records a ``LayerRecord`` per step,
    with the step's ``exch_bytes`` and wire format; the step and the drain
    share the host engine's ``_pipeline_body``, so results and traces are
    the same either way."""
    _check_mode(mode)
    roots = _as_roots(roots)
    num_roots = roots.shape[0]
    if num_roots < 1:
        raise ValueError("need at least one root")
    if not lanes:
        m_total = int(dg.deg.sum(dtype=np.int64))
        lanes = adaptive_lane_pool(num_roots, dg.n_orig, m_total)
    lanes = max(1, min(lanes, LANE_WORD_BITS * num_lane_words(num_roots)))
    state = dist2d_msbfs_engine_init(dg, mesh, capacity=num_roots,
                                     lanes=lanes)
    state = dist2d_msbfs_engine_enqueue(state, roots)
    if recorder is None:
        state = dist2d_msbfs_engine_drain(dg, state, mesh, mode, alpha, beta,
                                          max_pos, compress)
    else:
        from repro_torch.obs.sweeplog import drive_recorded
        state = drive_recorded(
            recorder, state,
            lambda s: dist2d_msbfs_engine_step(dg, s, mesh, mode, alpha,
                                               beta, max_pos, compress),
            dist2d_msbfs_engine_idle, kind="bfs",
            exch_format="compressed" if compress else "dense")
    return dist2d_msbfs_engine_result(dg, state, mesh,
                                      derive_parents=derive_parents)
