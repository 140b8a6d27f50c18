"""Engine facade of the analytics layer (port of
``repro.analytics.engine``).

Every analytics workload (components, closeness, k-hop, diameter bounds)
reduces to one primitive: one pipelined MS-BFS sweep over a batch of roots,
returning per-lane depths. ``LaneEngine`` is that primitive with the
lane-pool sizing folded in: ``lanes=None`` sizes the pool per sweep with
``packed.adaptive_lane_pool``, the ``lanes=0`` surface of the Graph500
harness. Sweeps run ``core.msbfs.msbfs_pipelined`` on the graph's device.

Built from a ``WeightedCSRGraph`` the engine also serves weighted sweeps:
``sssp_sweep`` runs the delta-stepping engine (``traversal.sssp``) over the
same graph, for the ``SSSPQuery`` / ``WeightedClosenessQuery`` workloads.
Boolean sweeps on a weighted engine ignore the weights.

``ndev > 1`` (on ``host_mesh(ndev)``, gloo for a graph on the CPU) or an
explicit ``mesh`` (even of one rank) runs the sweeps on the sharded engines
over a 1-D partition built once at construction: ``core.dist_msbfs
.dist_msbfs`` and, for a weighted graph, ``core.dist_sssp.dist_sssp``.
``grid=(pr, pc)`` runs them on the 2-D engines over a ``pr x pc`` grid
(``mesh2d``, ``core.dist2d.dist2d_msbfs``, ``core.dist_sssp.dist2d_sssp``),
and ``compress=True`` ships the grid's exchanges through the sparse codecs.
Results are trimmed to the original vertex count, so callers see the same
shapes either way. Such an engine is an SPMD program: every rank of the
process group builds it and runs the same sweeps.

``telemetry`` (a ``repro_torch.obs.Telemetry`` bundle) records every sweep
as a per-layer ``SweepRecorder`` stream; None keeps every sweep on the
drain path.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.csr import CSRGraph, WeightedCSRGraph
from repro_torch.core.hybrid import ALPHA_DEFAULT, BETA_DEFAULT
from repro_torch.core.msbfs import MSBFSResult, msbfs_pipelined
from repro_torch.core.packed import MODES, adaptive_lane_pool
from repro_torch.obs import spans
from repro_torch.traversal.sssp import DEFAULT_LANES, sssp_pipelined

__all__ = ["LaneEngine", "as_engine", "pad_roots"]


def pad_roots(roots: np.ndarray, width: int) -> np.ndarray:
    """Pad a root batch to the fixed sweep ``width`` by repeating the
    first root; callers discard the padded lanes' results. Shared by the
    analytics batch loops (components / closeness / diameter)."""
    roots = np.asarray(roots, np.int32)
    if roots.size > width:
        raise ValueError(
            f"{roots.size} roots exceed the fixed sweep width {width} — "
            f"an over-width batch would silently recompile per size")
    if roots.size == width:
        return roots
    return np.concatenate(
        [roots, np.full(width - roots.size, roots[0], np.int32)])


class LaneEngine:
    """MS-BFS (and SSSP) sweep runner shared by all analytics, on the
    graph's device or sharded over a mesh."""

    def __init__(self, g: CSRGraph | WeightedCSRGraph, *, ndev: int = 1,
                 mesh=None, grid: tuple[int, int] | None = None,
                 compress: bool = False, lanes: int | None = None,
                 mode: str = "hybrid", alpha: float = ALPHA_DEFAULT,
                 beta: float = BETA_DEFAULT, max_pos: int = 8,
                 probe_impl: str = "xla", telemetry=None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        # a repro_torch.obs.Telemetry bundle; None (the default) keeps every
        # sweep on the recorder-off drain path
        self.telemetry = telemetry
        self.wg = g if isinstance(g, WeightedCSRGraph) else None
        self.g = g.csr if self.wg is not None else g
        self.lanes = lanes
        self.mode = mode
        self.alpha = alpha
        self.beta = beta
        self.max_pos = max_pos
        # the SSSP lanes' relax_impl; on the card both relax kernels run
        # whatever it says (traversal/sssp.py::_relax)
        self.probe_impl = probe_impl
        self.grid = tuple(grid) if grid is not None else None
        self.compress = compress
        self.mesh = mesh
        self.dg = self.dg2 = self.dwg = self.dwg2 = None
        # the process group's backend follows the graph's device
        device = "cpu" if self.g.device.type == "cpu" else None
        if self.grid is not None:
            if mesh is not None:
                raise ValueError(
                    "pass grid=(pr, pc) or a mesh, not both: the 2-D engine "
                    "builds its own ('row', 'col') grid mesh")
            from repro_torch.core.dist2d import mesh2d, partition_graph_2d
            pr, pc = self.grid
            self.ndev = pr * pc
            self.mesh = mesh2d(pr, pc, device)
            self.dg2 = partition_graph_2d(self.g, pr, pc)
            if self.wg is not None:
                from repro_torch.core.dist_sssp import (
                    partition_weighted_graph_2d)
                self.dwg2 = partition_weighted_graph_2d(self.wg, pr, pc)
            return
        if compress:
            raise ValueError(
                "compress=True is the 2-D exchange's knob and needs "
                "grid=(pr, pc); the 1-D engine's exchange is always dense")
        if mesh is not None:
            ndev = mesh.mesh.numel()
        # the partition, as the results' metadata records it
        self.ndev = max(int(ndev), 1)
        # an explicit mesh takes the sharded path even at one rank: the
        # caller asked for that path
        if self.ndev > 1 or mesh is not None:
            from repro_torch.core.dist_msbfs import host_mesh, partition_graph
            if self.mesh is None:
                self.mesh = host_mesh(self.ndev, device)
            self.dg = partition_graph(self.g, self.ndev)
            if self.wg is not None:
                from repro_torch.core.dist_sssp import partition_weighted_graph
                self.dwg = partition_weighted_graph(self.wg, self.ndev)

    @property
    def n(self) -> int:
        return self.g.n

    @property
    def m(self) -> int:
        return self.g.m

    def lanes_for(self, num_roots: int) -> int:
        """Lane-pool width for a sweep of ``num_roots``: the pinned value
        or the adaptive sizing rule."""
        if self.lanes:
            return self.lanes
        return adaptive_lane_pool(num_roots, self.n, self.m)

    def _recorder(self, engine_name: str, **meta):
        """A fresh per-sweep ``SweepRecorder`` from the telemetry bundle
        (None when telemetry is absent or sweep recording is off — the
        drivers then take their drain path)."""
        if self.telemetry is None:
            return None
        return self.telemetry.recorder(engine_name, ndev=self.ndev, **meta)

    def sweep(self, roots, derive_parents: bool = False) -> MSBFSResult:
        """One pipelined engine sweep; ``depth`` is [n, R] on the graph's
        device. By default ``parent`` is zero-width: every analytics
        workload reads depths only, and the parent derivation is most of
        a sweep's time; pass ``derive_parents=True`` for Graph500
        parents. Under the torch profiler the sweep leaves a record of its
        spans and counters (``obs/spans.py``)."""
        with spans.sweep("analytics.sweep"):
            roots = np.asarray(roots, np.int32).reshape(-1)
            if roots.size < 1:
                raise ValueError("need at least one root")
            if self.dg2 is not None:
                from repro_torch.core.dist2d import dist2d_msbfs
                return dist2d_msbfs(self.dg2, roots, self.mesh, self.mode,
                                    self.alpha, self.beta, self.max_pos,
                                    lanes=self.lanes_for(roots.size),
                                    compress=self.compress,
                                    derive_parents=derive_parents,
                                    recorder=self._recorder("dist2d"))
            if self.dg is not None:
                from repro_torch.core.dist_msbfs import dist_msbfs
                return dist_msbfs(self.dg, roots, self.mesh, self.mode,
                                  self.alpha, self.beta, self.max_pos,
                                  lanes=self.lanes_for(roots.size),
                                  derive_parents=derive_parents,
                                  recorder=self._recorder("dist_msbfs"))
            return msbfs_pipelined(self.g, roots, mode=self.mode,
                                   alpha=self.alpha, beta=self.beta,
                                   max_pos=self.max_pos,
                                   lanes=self.lanes_for(roots.size),
                                   derive_parents=derive_parents,
                                   recorder=self._recorder("msbfs"))

    @property
    def weighted(self) -> bool:
        return self.wg is not None

    def sssp_lanes_for(self, num_roots: int) -> int:
        """Dense-lane pool width for a weighted sweep: dense float32 lanes
        cost about 32x a packed bit lane, so a pinned bit-pool width is
        capped at the tropical engine's own default."""
        cap = min(self.lanes, DEFAULT_LANES) if self.lanes else DEFAULT_LANES
        return max(1, min(num_roots, cap))

    def sssp_sweep(self, roots, delta=None):
        """One pipelined delta-stepping sweep over the engine's weighted
        graph; returns ``traversal.sssp.SSSPResult`` (``dist`` is float32
        [n, R] on the graph's device, inf unreached). It runs on the
        engine's partition, as ``sweep`` does: the host engine, the 1-D
        sharded engine on a mesh, the 2-D engine on a grid (``compress``
        ships its value exchanges through the sparse codec); the results
        are the same. ``delta`` is a scalar width or a per-lane tuple (None
        picks the graph default). Under the torch profiler the sweep
        leaves a record of its spans and counters (``obs/spans.py``)."""
        if self.wg is None:
            raise TypeError(
                "weighted sweep on an unweighted engine — build the "
                "LaneEngine from a WeightedCSRGraph (e.g. "
                "graph.generator.rmat_weighted_graph) to serve "
                "sssp/weighted-closeness queries")
        with spans.sweep("analytics.sssp_sweep"):
            roots = np.asarray(roots, np.int32).reshape(-1)
            if roots.size < 1:
                raise ValueError("need at least one source")
            lanes = self.sssp_lanes_for(roots.size)
            if self.dwg2 is not None:
                from repro_torch.core.dist_sssp import dist2d_sssp
                return dist2d_sssp(self.dwg2, roots, self.mesh, delta=delta,
                                   lanes=lanes, max_pos=self.max_pos,
                                   relax_impl=self.probe_impl,
                                   compress=self.compress,
                                   recorder=self._recorder("dist2d_sssp"))
            if self.dwg is not None:
                from repro_torch.core.dist_sssp import dist_sssp
                return dist_sssp(self.dwg, roots, self.mesh, delta=delta,
                                 lanes=lanes, max_pos=self.max_pos,
                                 relax_impl=self.probe_impl,
                                 recorder=self._recorder("dist_sssp"))
            return sssp_pipelined(self.wg, roots, delta=delta, lanes=lanes,
                                  max_pos=self.max_pos,
                                  relax_impl=self.probe_impl,
                                  recorder=self._recorder("sssp"))


def as_engine(g_or_engine, **kwargs) -> LaneEngine:
    """Accept either a graph (build an engine with ``kwargs``) or an
    already-built ``LaneEngine`` (reuse it — kwargs must then be empty, a
    half-applied override would silently diverge from the engine's
    config)."""
    if isinstance(g_or_engine, LaneEngine):
        if kwargs:
            raise ValueError(
                f"engine already built; unexpected overrides {sorted(kwargs)}")
        return g_or_engine
    return LaneEngine(g_or_engine, **kwargs)
