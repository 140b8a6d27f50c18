"""Distributed multi-source BFS: the bit-lane engine over a 1-D partition
(port of ``repro.core.dist_msbfs`` on ``torch.distributed``).

The pipelined packed engine (``core/msbfs.py``) over ``dist_bfs``'s 1-D
vertex partition, run by the host engine's own step, refill, retirement and
result on a sharded state: each rank runs the packed step
(``core/packed.py::dispatch_packed_step``, so the ``msbfs_probe`` and
``segment_or`` kernels on the GPU) over its local CSR block against the
full replicated ``[n, W]`` frontier, and produces the new frontier words of
its own rows. The ranks own disjoint rows, so the layer's exchange is an
all-gather of those row blocks in mesh order (the reference ORs placed
``[n, W]`` blocks, ``allreduce_or``, which gives the same bits for the
ranks' words times more bytes); the Buluc-Madduri frontier exchange on the
packed representation.

An SPMD program: every rank of the mesh calls the same engine functions with
the same arguments. Control state (the root queue, the lane bindings, the
per-lane direction flags, the traces) is host numpy and the same on every
rank, because the only values it reads, the per-lane counters of the new
state, are summed over the ranks first (one all-reduce and one host read a
step, the host engine's one sync). So the engine's lane and queue
evolution, and with it every per-root result and trace, is the host
engine's. This module keeps the partition, the mesh and the trimming of
the gathered rows.

Per-rank state:
  frontier   word_dtype()[n, W]      replicated, n padded to ndev * 32
  visited    word_dtype()[n_loc, W]  the rank's rows
  depth      int32[n_loc, L]
  out_depth  int32[n_loc, capacity+1]
  everything else (queue, lanes, counters, traces): host, replicated.

The switch rule uses ``n_orig``, not the padded ``n``: padded vertices have
degree 0 and never traverse, so with the original vertex count every lane's
trace replays its serial run.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.csr import CSRGraph
from repro_torch.core.dist_bfs import (DistGraph, check_partition,
                                       mesh_device, partition_graph)
from repro_torch.core.exchange import allreduce_or, mesh_comm
from repro_torch.core.hybrid import ALPHA_DEFAULT, BETA_DEFAULT
from repro_torch.core.msbfs import (MAX_LANES, LayerReadout, MSBFSResult,
                                    PipelineState, _as_roots, _check_mode,
                                    _fresh_state, _pipeline_body,
                                    msbfs_engine_enqueue, msbfs_engine_idle,
                                    msbfs_engine_readout, msbfs_engine_result,
                                    msbfs_engine_retire)
from repro_torch.core.packed import (LANE_WORD_BITS, adaptive_lane_pool,
                                     num_lane_words)

__all__ = [
    "DistGraph", "DistPipelineState", "allreduce_or", "dist_msbfs",
    "dist_msbfs_engine_drain", "dist_msbfs_engine_enqueue",
    "dist_msbfs_engine_idle", "dist_msbfs_engine_init",
    "dist_msbfs_engine_readout", "dist_msbfs_engine_result",
    "dist_msbfs_engine_retire", "dist_msbfs_engine_step", "host_mesh",
    "partition_graph",
]


# The host engine's state serves the sharded engine: its row-indexed device
# arrays hold the rank's block (from global row ``base``), ``comm`` is the
# mesh group, and the degrees and counters are global (msbfs.py).
DistPipelineState = PipelineState


def host_mesh(ndev: int, device=None):
    """A 1-D ``("data",)`` mesh over the initialised process group, which
    must have ``ndev`` ranks: on the GPU for ``device=None`` (NCCL, each
    rank on its ``cuda:<local rank>``), on the CPU for ``device="cpu"``
    (gloo). Raises without a group, with another world size, or with the
    other device's backend, and says how to launch."""
    return group_mesh(f"host_mesh({ndev})", (ndev,), ("data",), device)


def group_mesh(what: str, shape: tuple, names: tuple, device=None):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the whole
    initialised process group, on the device type ``device`` names (the
    GPU for None): ``host_mesh``'s and ``dist2d.mesh2d``'s checks, their
    errors naming ``what``."""
    ndev = int(np.prod(shape))
    launch = (f"launch the program on {ndev} ranks with "
              f"repro_torch.distributed.ranks.run_ranks(fn, {ndev}, ...) or "
              f"torchrun --nproc-per-node {ndev}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"{what} needs an initialised torch.distributed "
                           f"process group: {launch}")
    world = dist.get_world_size()
    if world != ndev:
        raise ValueError(f"{what} needs {ndev} ranks, and the process group "
                         f"has {world}: {launch}")
    device_type = "cpu" if (device is not None and torch.device(
        device).type == "cpu") else "cuda"
    want = "gloo" if device_type == "cpu" else "nccl"
    backend = str(dist.get_backend())
    if backend != want:
        raise ValueError(f"a {device_type} mesh needs the {want} backend, "
                         f"and the process group runs {backend}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def dist_msbfs_engine_init(dg: DistGraph, mesh, capacity: int,
                           lanes: int = MAX_LANES) -> DistPipelineState:
    """Fresh engine on this rank's device: all lanes idle, an empty root
    queue of ``capacity`` slots."""
    check_partition(dg, mesh)
    comm = mesh_comm(mesh)
    blk = dg.local(comm.index, mesh_device(mesh))
    return _fresh_state(dg.deg.reshape(-1), dg.n_loc, blk.g.device, capacity,
                        lanes, base=blk.base, comm=comm)


def _block(dg: DistGraph, state: DistPipelineState) -> CSRGraph:
    """The rank's block of the graph, on the state's device (cached)."""
    return dg.local(state.comm.index, state.frontier.device).g


# the queue and the lanes are host state, the same on every rank
dist_msbfs_engine_enqueue = msbfs_engine_enqueue
dist_msbfs_engine_idle = msbfs_engine_idle


def dist_msbfs_engine_step(dg: DistGraph, state: DistPipelineState, mesh,
                           mode: str = "hybrid",
                           alpha: float = ALPHA_DEFAULT,
                           beta: float = BETA_DEFAULT,
                           max_pos: int = 8) -> DistPipelineState:
    """Advance the engine by one traversal layer on every rank (streaming
    API): the host engine's step on the rank's block. A step consumes the
    state it is given: keep stepping the state a step returns."""
    _check_mode(mode)
    check_partition(dg, mesh)
    return _pipeline_body(_block(dg, state), state, mode, alpha, beta,
                          max_pos, n=dg.n_orig)


def dist_msbfs_engine_drain(dg: DistGraph, state: DistPipelineState, mesh,
                            mode: str = "hybrid",
                            alpha: float = ALPHA_DEFAULT,
                            beta: float = BETA_DEFAULT,
                            max_pos: int = 8) -> DistPipelineState:
    """Step the engine until every enqueued root has been answered."""
    _check_mode(mode)
    check_partition(dg, mesh)
    g = _block(dg, state)
    while not msbfs_engine_idle(state):
        state = _pipeline_body(g, state, mode, alpha, beta, max_pos,
                               n=dg.n_orig)
    return state


def dist_msbfs_engine_result(dg: DistGraph, state: DistPipelineState, mesh,
                             trim: bool = True,
                             derive_parents: bool = True) -> MSBFSResult:
    """An ``MSBFSResult`` over the enqueued queue slots on this rank's
    device, the same on every rank: the host engine's result, its depths
    gathered from the flushed row blocks and its parents derived on each
    block (``derive_parents=False`` gives a zero-width ``parent``). With
    ``trim`` the rows are cut back to the original vertex count."""
    check_partition(dg, mesh)
    res = msbfs_engine_result(_block(dg, state), state, derive_parents)
    lim = dg.n_orig if trim else dg.n
    return res._replace(parent=res.parent[:lim], depth=res.depth[:lim])


def dist_msbfs_engine_readout(dg: DistGraph,
                              state: DistPipelineState) -> LayerReadout:
    """The host engine's ``LayerReadout`` of the sharded engine, the row
    blocks gathered into global order and trimmed to the original vertex
    count, so streaming consumers do not see the partition. Collective:
    every rank calls it."""
    ro = msbfs_engine_readout(state)
    n = dg.n_orig
    return ro._replace(depth=ro.depth[:n], out_depth=ro.out_depth[:n])


def dist_msbfs_engine_retire(dg: DistGraph, state: DistPipelineState,
                             lane_mask) -> DistPipelineState:
    """Retire the masked active lanes early: the host engine's
    ``msbfs_engine_retire`` on the rank's block. The mask is host state,
    the same on every rank, and the counters are global, so no collective
    is needed."""
    return msbfs_engine_retire(_block(dg, state), state, lane_mask)


def dist_msbfs(dg: DistGraph, roots, mesh, mode: str = "hybrid",
               alpha: float = ALPHA_DEFAULT, beta: float = BETA_DEFAULT,
               max_pos: int = 8, lanes: int | None = None,
               derive_parents: bool = True, recorder=None) -> MSBFSResult:
    """Answer any number of roots in one sharded engine sweep, on every
    rank of ``mesh``.

    ``lanes=None`` (or 0) sizes the lane pool from the root count and the
    graph's degree (``packed.adaptive_lane_pool``). Every lane equals the
    serial ``bfs`` and the host engine; results are trimmed to the
    original vertex count. ``recorder`` (a ``repro_torch.obs
    .SweepRecorder``) records a ``LayerRecord`` per step; the step and the
    drain share the host engine's ``_pipeline_body``, so results and
    traces are the same either way."""
    _check_mode(mode)
    roots = _as_roots(roots)
    num_roots = roots.shape[0]
    if num_roots < 1:
        raise ValueError("need at least one root")
    if not lanes:
        m_total = int(dg.deg.sum(dtype=np.int64))
        lanes = adaptive_lane_pool(num_roots, dg.n_orig, m_total)
    # W follows the active batch: a small R never pays for idle words
    lanes = max(1, min(lanes, LANE_WORD_BITS * num_lane_words(num_roots)))
    state = dist_msbfs_engine_init(dg, mesh, capacity=num_roots, lanes=lanes)
    state = dist_msbfs_engine_enqueue(state, roots)
    if recorder is None:
        state = dist_msbfs_engine_drain(dg, state, mesh, mode, alpha, beta,
                                        max_pos)
    else:
        from repro_torch.obs.sweeplog import drive_recorded
        state = drive_recorded(
            recorder, state,
            lambda s: dist_msbfs_engine_step(dg, s, mesh, mode, alpha, beta,
                                             max_pos),
            dist_msbfs_engine_idle, kind="bfs")
    return dist_msbfs_engine_result(dg, state, mesh,
                                    derive_parents=derive_parents)
