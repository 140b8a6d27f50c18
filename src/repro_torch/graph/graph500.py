"""Graph500 experimental harness (paper §6).

Runs the benchmark protocol: generate a Kronecker graph, pick 64 random
roots (degree > 0, as the reference code does), run one BFS per root,
collect per-root wall time and TEPS, and report the harmonic mean (the
paper's headline number) plus min/max/mean.

``batched=True`` answers all roots (``num_roots`` may exceed 64) in one
sweep of the pipelined multi-source engine (``core/msbfs.py``): roots
beyond the ``lanes`` bit-lane pool wait in the engine's queue and refill
lanes as traversals finish. Per-root wall time is then the shared sweep
time, and ``aggregate_teps`` (total edges over total wall time) is the
number to compare with the serial loop. With ``ndev > 1`` or a ``mesh`` the
sweep runs the sharded engine (``core/dist_msbfs.py``) over
``partition_graph(g, ndev)``: an SPMD program, so every rank of the process
group calls ``run_graph500`` with the same arguments.

TEPS counts the *undirected* edges of the traversed component (sum of
degrees of reached vertices / 2), per the Graph500 spec. Each root's time
ends with a device synchronise, so it covers the whole traversal.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.csr import CSRGraph, to_numpy_adj
from repro_torch.core.hybrid import bfs
from repro_torch.core.msbfs import MAX_LANES, msbfs_pipelined
from repro_torch.core.packed import adaptive_lane_pool
from repro_torch.device import device_name, resolve_device
from repro_torch.graph.generator import rmat_graph, sample_roots
from repro_torch.graph.validate import validate_bfs_tree


@dataclass
class Graph500Result:
    scale: int
    edgefactor: int
    mode: str
    batched: bool = False
    lanes: int = 0               # bit-lane pool of the batched engine
    ndev: int = 1                # devices the batched engine ran on
    device: str = ""
    roots: list[int] = field(default_factory=list)
    teps: list[float] = field(default_factory=list)
    times: list[float] = field(default_factory=list)
    traversed: list[int] = field(default_factory=list)

    @property
    def harmonic_mean_teps(self) -> float:
        t = np.asarray([x for x in self.teps if x > 0])
        return float(len(t) / np.sum(1.0 / t)) if len(t) else 0.0

    @property
    def aggregate_teps(self) -> float:
        """Total traversed edges over total wall time."""
        total_t = float(np.sum(self.times))
        return float(np.sum(self.traversed)) / total_t if total_t > 0 else 0.0

    def summary(self) -> dict:
        t = np.asarray(self.teps)
        return dict(scale=self.scale, edgefactor=self.edgefactor,
                    mode=self.mode, batched=self.batched, lanes=self.lanes,
                    ndev=self.ndev, device=self.device,
                    nroots=len(self.traversed),
                    harmonic_mean_teps=self.harmonic_mean_teps,
                    aggregate_teps=self.aggregate_teps,
                    mean_teps=float(t.mean()) if len(t) else 0.0,
                    max_teps=float(t.max()) if len(t) else 0.0,
                    min_teps=float(t.min()) if len(t) else 0.0,
                    mean_time=float(np.mean(self.times)) if self.times else 0.0)


# serial mode name -> multi-source controller mode
_BATCHED_MODE = {"hybrid": "hybrid", "hybrid_nosimd": "hybrid",
                 "topdown": "topdown", "bottomup_simd": "bottomup",
                 "bottomup_nosimd": "bottomup"}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_graph500(scale: int, edgefactor: int, mode: str = "hybrid",
                 num_roots: int = 64, seed: int = 0, validate: bool = False,
                 alpha: float = 14.0, beta: float = 24.0, max_pos: int = 8,
                 warmup: bool = True, skip_empty_fallback: bool = True,
                 td_impl: str = "edge", graph: CSRGraph | None = None,
                 batched: bool = False, lanes: int | None = MAX_LANES,
                 ndev: int = 1, mesh=None, device=None) -> Graph500Result:
    """Graph500 run on ``device`` (the GPU unless the caller passes
    another; ``graph`` brings its own device): one BFS per root, or with
    ``batched=True`` one pipelined multi-source sweep over all roots.
    ``ndev > 1`` (on ``host_mesh(ndev)``) or a ``DeviceMesh`` (even of one
    rank) runs that sweep sharded; the serial harness has no distributed
    form."""
    if (ndev > 1 or mesh is not None) and not batched:
        raise ValueError("ndev > 1 requires batched=True (the sharded "
                         "engine is the MS-BFS one)")
    if graph is None:
        g = rmat_graph(scale, edgefactor, seed, device=resolve_device(device))
    else:
        g = graph
    dev = g.device
    roots = sample_roots(g, num_roots, seed=seed + 1)
    if batched:
        if td_impl != "edge" or not skip_empty_fallback:
            raise ValueError(
                "batched=True does not support td_impl/skip_empty_fallback "
                "(the MS-BFS sweep has its own step formulations)")
        return _run_batched(g, roots, scale, edgefactor, mode, alpha, beta,
                            max_pos, warmup, validate, lanes, ndev, mesh)
    res = Graph500Result(scale=scale, edgefactor=edgefactor, mode=mode,
                         device=device_name(dev),
                         roots=[int(r) for r in roots])

    def run(r):
        return bfs(g, r, mode, alpha, beta, max_pos, skip_empty_fallback,
                   td_impl)

    if warmup and len(roots):
        run(int(roots[0]))  # first use builds the kernels
        _sync(dev)

    rp, ci = to_numpy_adj(g) if validate else (None, None)
    for r in roots:
        t0 = time.perf_counter()
        out = run(int(r))
        _sync(dev)
        dt = time.perf_counter() - t0
        edges = int(out.edges_traversed) // 2
        res.times.append(dt)
        res.traversed.append(edges)
        res.teps.append(edges / dt if dt > 0 else 0.0)
        if validate:
            validate_bfs_tree(rp, ci, out.parent.cpu().numpy(), int(r))
    return res


def _run_batched(g: CSRGraph, roots: np.ndarray, scale: int, edgefactor: int,
                 mode: str, alpha: float, beta: float, max_pos: int,
                 warmup: bool, validate: bool, lanes: int | None,
                 ndev: int = 1, mesh=None) -> Graph500Result:
    """All roots in one pipelined multi-source sweep. ``lanes=None`` (or 0)
    sizes the lane pool from the root count and the graph's degree
    (``adaptive_lane_pool``). The timed sweep covers the engine and the
    parent derivation and ends with a device sync. The result's ``mode`` is
    the multi-source controller that ran (there is no packed non-SIMD
    variant).

    ``ndev > 1`` or a ``mesh`` runs the sharded engine over a 1-D
    partition of ``g`` (one block per rank, built on the host), on this
    rank's device; the mesh is ``host_mesh(ndev)`` on the graph's device
    type when none is given."""
    msbfs_mode = _BATCHED_MODE[mode]
    if not lanes:
        lanes = adaptive_lane_pool(len(roots), g.n, g.m)
    dev = g.device
    if ndev > 1 or mesh is not None:
        from repro_torch.core.dist_bfs import mesh_device
        from repro_torch.core.dist_msbfs import (dist_msbfs, host_mesh,
                                                 partition_graph)
        from repro_torch.core.exchange import mesh_comm
        if mesh is None:
            mesh = host_mesh(ndev, "cpu" if dev.type == "cpu" else None)
        ndev = mesh.mesh.numel()
        dg = partition_graph(g, ndev)
        dev = mesh_device(mesh)
        # the rank's block goes to its device here, outside the timing, as
        # the host engine's graph is on its device before the timing
        dg.local(mesh_comm(mesh).index, dev)

        def run():
            return dist_msbfs(dg, roots, mesh, msbfs_mode, alpha, beta,
                              max_pos, lanes=lanes)
    else:
        def run():
            return msbfs_pipelined(g, roots, msbfs_mode, alpha, beta,
                                   max_pos, lanes)

    res = Graph500Result(scale=scale, edgefactor=edgefactor, mode=msbfs_mode,
                         batched=True, lanes=lanes, ndev=ndev,
                         device=device_name(dev),
                         roots=[int(r) for r in roots])
    if warmup:
        run()  # first use builds the kernels
        _sync(dev)
    t0 = time.perf_counter()
    out = run()
    _sync(dev)
    dt = time.perf_counter() - t0
    edges = out.edges_traversed.cpu().numpy() // 2
    res.times.append(dt)
    res.traversed.extend(int(e) for e in edges)
    # per-root TEPS against the shared sweep time; aggregate_teps is the
    # headline
    res.teps.extend(float(e) / dt if dt > 0 else 0.0 for e in edges)
    if validate:
        rp, ci = to_numpy_adj(g)
        parent = out.parent.cpu().numpy()
        for r_i, root in enumerate(roots):
            validate_bfs_tree(rp, ci, parent[:, r_i], int(root))
    return res
