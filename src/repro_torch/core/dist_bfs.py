"""Distributed hybrid BFS over ``torch.distributed``: the multi-device form
of the paper (port of ``repro.core.dist_bfs``).

1-D vertex partition over all mesh axes flattened: block d (the rank at
position d of ``mesh.mesh.flatten()``) owns a contiguous vertex slice and
the CSR rows of its vertices. An SPMD program: every rank of the mesh calls
``dist_bfs`` with the same arguments and gets the same replicated result.
Per layer:

  counters   the local (e_f, v_f, e_u) in one all-reduce SUM, read back
             once (the layer's one host sync); every rank takes the same
             direction from them;
  top-down   scan the local slots of local frontier rows, emit parent
             candidates over the whole vertex range into an int32[n]
             buffer (scatter-min), all-reduce MIN, keep the own slice;
  bottom-up  all-gather the packed frontier bitmap (n/32 words), then the
             paper's probe (the ``bottom_up_probe`` kernel on the GPU) over
             the local rows against the global bitmap, then the plain
             local scan of the rows the probe left.

Determinism matches the single-device path: the min parent id wins
everywhere, so ``dist_bfs`` equals ``hybrid.bfs`` and the numpy oracle.
The partition is built on the host; a rank moves its own block to its
device once (``DistGraph.local``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bitmap
from repro_torch.core.csr import CSRGraph
from repro_torch.core.exchange import all_gather, mesh_comm, pmin, psum
from repro_torch.core.hybrid import switch_direction
from repro_torch.kernels.bottom_up_probe.ops import bottom_up_probe

MAX_LAYERS = 64
MODES = ("hybrid", "topdown", "bottomup")


class DistBFSResult(NamedTuple):
    """Single-root distributed BFS result, with the serial and multi-source
    engines' conventions: unreached vertices hold -1 in both parent and
    depth, ``parent[root] == root``, ``depth[root] == 0``. Arrays are
    trimmed to the original (unpadded) vertex count, on the rank's
    device."""
    parent: torch.Tensor       # int32[n_orig], -1 unreached
    depth: torch.Tensor        # int32[n_orig], -1 unreached
    num_layers: torch.Tensor   # int32 scalar


class LocalBlock(NamedTuple):
    """One rank's block of a ``DistGraph`` on its device."""
    g: CSRGraph          # row_ptr [n_loc+1], col_idx [m_loc] (global ids),
    #                      src_idx = src_loc (local row of each slot)
    deg: torch.Tensor    # int32[n_loc]
    base: int            # first global vertex id of the block


@dataclass(frozen=True)
class DistGraph:
    """Host-partitioned CSR: stacked per-block numpy arrays (leading dim =
    ndev), as the reference stacks its device blocks."""
    row_ptr: np.ndarray   # int32[ndev, n_loc+1], local offsets into col_idx
    col_idx: np.ndarray   # int32[ndev, m_loc], global neighbour ids (pad: n)
    src_loc: np.ndarray   # int32[ndev, m_loc], local row of each slot
    deg: np.ndarray       # int32[ndev, n_loc]
    n: int                # padded global vertex count (multiple of ndev*32)
    n_orig: int           # original vertex count
    m_loc: int            # uniform per-block edge-slab size (padded)
    _blocks: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def ndev(self) -> int:
        return self.row_ptr.shape[0]

    @property
    def n_loc(self) -> int:
        return self.n // self.ndev

    def local(self, index: int, device) -> LocalBlock:
        """Block ``index`` on ``device``, moved there once and cached."""
        device = torch.device(device)
        key = (index, str(device))
        if key not in self._blocks:
            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a[index])).to(
                    device)
            self._blocks[key] = LocalBlock(
                g=CSRGraph(row_ptr=put(self.row_ptr),
                           col_idx=put(self.col_idx),
                           src_idx=put(self.src_loc)),
                deg=put(self.deg), base=index * self.n_loc)
        return self._blocks[key]


def partition_graph(g: CSRGraph, ndev: int) -> DistGraph:
    """Host-side 1-D partition with uniform padding across blocks: ``n``
    padded to a multiple of ``ndev * 32`` (so each block's bitmap is whole
    words), edge slabs padded to the longest with ``col = n`` (which fails
    every bitmap test) and ``src_loc = 0``: a pad slot lies past its
    block's ``row_ptr[-1]``, in no row."""
    rp = g.row_ptr.cpu().numpy()
    ci = g.col_idx.cpu().numpy()
    n_orig = g.n
    block = -(-n_orig // (ndev * 32)) * 32          # n_loc, a multiple of 32
    n = block * ndev
    deg_full = np.zeros(n, np.int32)
    deg_full[:n_orig] = np.diff(rp)
    deg_l = deg_full.reshape(ndev, block)

    row_ptr_l = np.zeros((ndev, block + 1), np.int32)
    np.cumsum(deg_l, axis=1, out=row_ptr_l[:, 1:])

    slabs, srcs = [], []
    for d in range(ndev):
        lo_v, hi_v = d * block, min((d + 1) * block, n_orig)
        if lo_v < n_orig:
            slab = ci[rp[lo_v]:rp[hi_v]]
            src = np.repeat(np.arange(hi_v - lo_v, dtype=np.int32),
                            np.diff(rp[lo_v:hi_v + 1]))
        else:
            slab = src = np.zeros(0, np.int32)
        slabs.append(slab)
        srcs.append(src)
    m_loc = max(1, max(len(s) for s in slabs))
    col_l = np.full((ndev, m_loc), n, np.int32)
    src_l = np.zeros((ndev, m_loc), np.int32)
    for d in range(ndev):
        col_l[d, :len(slabs[d])] = slabs[d]
        src_l[d, :len(srcs[d])] = srcs[d]
    return DistGraph(row_ptr=row_ptr_l, col_idx=col_l, src_loc=src_l,
                     deg=deg_l, n=n, n_orig=n_orig, m_loc=m_loc)


def check_partition(dg: DistGraph, mesh) -> int:
    """The mesh's size, which must be the partition's block count."""
    ndev = mesh.mesh.numel()
    if dg.ndev != ndev:
        raise ValueError(
            f"DistGraph partitioned for {dg.ndev} devices but mesh has "
            f"{ndev}: repartition with partition_graph(g, {ndev})")
    return ndev


def mesh_device(mesh) -> torch.device:
    """This rank's device for ``mesh``: the current CUDA device of a CUDA
    mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _layer_counts(frontier, visited, deg, comm):
    """The layer's (e_f, v_f, e_u) over all ranks: one int32[3]
    all-reduce SUM of the local counts."""
    return psum(torch.stack([torch.where(frontier, deg, 0).sum(),
                             frontier.sum(),
                             torch.where(visited, 0, deg).sum()]).to(
        torch.int32), comm)


def _topdown(blk: LocalBlock, frontier, visited, parent, n: int, comm):
    """Candidates of the local frontier rows' slots over all n vertices
    (pad slots, col = n, are excluded), MIN over the ranks, the own slice
    kept."""
    g = blk.g
    act = frontier[g.src_idx] & (g.col_idx < n)
    cand = torch.where(act, blk.base + g.src_idx, n)
    full = torch.full((n,), n, dtype=torch.int32, device=g.device)
    full.scatter_reduce_(0, g.col_idx.clamp(0, n - 1).long(), cand, "amin")
    full = pmin(full, comm)
    mine = full[blk.base:blk.base + frontier.shape[0]]
    new = (mine < n) & ~visited
    return new, visited | new, torch.where(new, mine, parent)


def _bottomup(blk: LocalBlock, frontier, visited, parent, max_pos: int,
              comm):
    """The probe over the local rows against the all-gathered bitmap, then
    the plain local scan beyond ``max_pos`` of the rows it left."""
    g, deg = blk.g, blk.deg
    fw = all_gather(bitmap.pack(frontier), comm).reshape(-1)
    unv = ~visited
    found, parent = bottom_up_probe(g.row_ptr, g.col_idx, fw, unv, parent,
                                    max_pos)
    m_loc = g.m
    e = torch.arange(m_loc, dtype=torch.int32, device=g.device)
    pos_e = e - g.row_ptr[g.src_idx]
    rem = unv & ~found & (deg > max_pos)
    act = rem[g.src_idx] & (pos_e >= max_pos) & bitmap.test(fw, g.col_idx)
    e_min = torch.full((deg.shape[0],), m_loc, dtype=torch.int32,
                       device=g.device)
    e_min.scatter_reduce_(0, g.src_idx.long(), torch.where(act, e, m_loc),
                          "amin")
    hit2 = e_min < m_loc
    parent = torch.where(hit2, g.col_idx[e_min.clamp(0, m_loc - 1)], parent)
    new = (found | hit2) & unv
    return new, visited | new, parent


def dist_bfs(dg: DistGraph, root, mesh, mode: str = "hybrid",
             alpha: float = 14.0, beta: float = 24.0,
             max_pos: int = 8) -> DistBFSResult:
    """Run one distributed BFS from ``root`` on every rank of ``mesh`` (a
    ``torch.distributed`` ``DeviceMesh``); returns the replicated
    ``DistBFSResult`` on this rank's device.

    ``mode`` is "hybrid" (the alpha/beta switch, on the padded vertex count
    as in the reference), "topdown" or "bottomup"."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    check_partition(dg, mesh)
    comm = mesh_comm(mesh)
    blk = dg.local(comm.index, mesh_device(mesh))
    n, n_loc, dev = dg.n, dg.n_loc, blk.g.device
    root = int(root)
    deg = blk.deg
    local_ids = blk.base + torch.arange(n_loc, dtype=torch.int32, device=dev)
    frontier = local_ids == root
    visited = frontier
    parent = torch.where(frontier, root, -1).to(torch.int32)
    depth = torch.where(frontier, 0, -1).to(torch.int32)
    topdown = mode != "bottomup"
    layer = 0
    while layer < MAX_LAYERS:
        e_f, v_f, e_u = _layer_counts(frontier, visited, deg, comm).tolist()
        if layer and not v_f:    # the last step found nothing
            break
        if mode == "hybrid":
            topdown = bool(switch_direction(topdown, e_f, v_f, e_u, n,
                                            alpha, beta))
        if topdown:
            frontier, visited, parent = _topdown(blk, frontier, visited,
                                                 parent, n, comm)
        else:
            frontier, visited, parent = _bottomup(blk, frontier, visited,
                                                  parent, max_pos, comm)
        depth = torch.where(frontier, layer + 1, depth)
        layer += 1
    parent = all_gather(parent, comm).reshape(-1)[:dg.n_orig]
    depth = all_gather(depth, comm).reshape(-1)[:dg.n_orig]
    return DistBFSResult(parent=parent, depth=depth,
                         num_layers=torch.tensor(layer, dtype=torch.int32,
                                                 device=dev))


__all__ = ["DistBFSResult", "DistGraph", "MAX_LAYERS", "check_partition",
           "dist_bfs", "mesh_device", "partition_graph"]
