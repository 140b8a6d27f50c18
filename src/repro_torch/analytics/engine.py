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
explicit ``mesh`` (even of one rank) runs the boolean sweeps on the sharded
engine ``core.dist_msbfs.dist_msbfs`` over a 1-D partition built once at
construction; results are trimmed to the original vertex count, so callers
see the same shapes either way. Such an engine is an SPMD program: every
rank of the process group builds it and runs the same sweeps. Its weighted
sweeps wait for the distributed SSSP engine (ROADMAP queue A item 9 (c)),
and the 2-D knobs ``grid`` and ``compress`` for the 2-D engine (item 9
(b)); both raise ``NotImplementedError``.

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
        for name, value in (("grid=", grid is not None),
                            ("compress=True", compress)):
            if value:
                raise NotImplementedError(
                    f"{name} needs the 2-D distributed engine, which is not "
                    f"ported yet (ROADMAP queue A item 9 (b))")
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
        self.grid = None
        self.compress = False
        self.mesh = mesh
        self.dg = None
        if mesh is not None:
            ndev = mesh.mesh.numel()
        # the partition, as the results' metadata records it
        self.ndev = max(int(ndev), 1)
        # an explicit mesh takes the sharded path even at one rank: the
        # caller asked for that path
        if self.ndev > 1 or mesh is not None:
            from repro_torch.core.dist_msbfs import host_mesh, partition_graph
            if self.mesh is None:
                self.mesh = host_mesh(
                    self.ndev, "cpu" if self.g.device.type == "cpu" else None)
            self.dg = partition_graph(self.g, self.ndev)

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
        parents."""
        roots = np.asarray(roots, np.int32).reshape(-1)
        if roots.size < 1:
            raise ValueError("need at least one root")
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
        [n, R] on the graph's device, inf unreached). ``delta`` is a
        scalar width or a per-lane tuple (None picks the graph
        default)."""
        if self.wg is None:
            raise TypeError(
                "weighted sweep on an unweighted engine — build the "
                "LaneEngine from a WeightedCSRGraph (e.g. "
                "graph.generator.rmat_weighted_graph) to serve "
                "sssp/weighted-closeness queries")
        if self.dg is not None:
            raise NotImplementedError(
                "weighted sweeps on a distributed engine need the sharded "
                "SSSP engine (dist_sssp), which is not ported yet (ROADMAP "
                "queue A item 9 (c))")
        roots = np.asarray(roots, np.int32).reshape(-1)
        if roots.size < 1:
            raise ValueError("need at least one source")
        return sssp_pipelined(self.wg, roots, delta=delta,
                              lanes=self.sssp_lanes_for(roots.size),
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
