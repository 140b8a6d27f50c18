"""AnalyticsService — the async front door over the lane engines (port of
``repro.serving.service``).

One service instance owns the two lane pools (the packed MS-BFS engine
and, on weighted graphs, the delta-stepping tropical engine) and serves
typed ``AnalyticsRequest`` envelopes through an explicit lifecycle::

    submit() -> REJECTED | QUEUED          (admission.AdmissionController)
    step()      QUEUED   -> RUNNING        (lanes enqueued, FIFO per engine)
                RUNNING  -> DONE           (answer collected)

The service is driven one *layer* at a time — ``step()`` dispatches
pending requests into free queue slots, advances both engines by one
layer/phase, and collects answers. Drive it synchronously
(``run_until_idle`` / ``replay``) or start the worker thread
(``start()``) and use ``submit``/``poll``/``result`` from any thread.

**Streaming read-outs** are the engine-side unlock this service exists
for: BFS depths already assigned are FINAL, so a depth-k ``KHopQuery``
is answerable the moment its lane's layer counter passes ``k`` — the
service reads the mid-sweep ``LayerReadout`` surface
(``msbfs_engine_readout``), assembles the answer through the SAME
``khop_result_from_depth`` constructor as the offline path (bit-identical
by construction), and retires the lane early
(``msbfs_engine_retire``) so the pool capacity goes back to work.
``ReachQuery`` answers stream the same way once every target vertex has
a depth. ``streaming=False`` falls back to answer-at-flush.

**Scheduling.** Each engine's queue is FIFO with head-of-line blocking:
a request that doesn't fit the remaining queue slots blocks later
requests *for that engine only* (no starvation by reordering; the other
engine keeps dispatching). When a pool drains — no running requests and
the engine idle — its queue slots recycle for the next epoch.
Whole-graph workloads (components, diameter, weighted closeness) and
sssp requests whose delta differs from the service's pinned bucket
width don't ride the shared pools at all: they execute inline through
``answer_request`` on the shared ``LaneEngine`` — the SAME handler table
as ``run_query``, so every answer the service produces is parity-checked
against the offline path by construction.

In the port the pools are the host engines on the graph's device, or,
when the service's ``LaneEngine`` is partitioned (``ndev > 1``, or an
explicit ``mesh`` even of one rank), the 1-D sharded engines
(``core.dist_msbfs``, ``core.dist_sssp``) on that mesh. The service is
1-D only, as the reference's is: ``grid=`` is not one of its options. A
sharded service is an SPMD program: every rank of the mesh builds it, rank
0 of the mesh is the only front door, and the other ranks run
``follow()`` (``serving.frontdoor``; ``lead(drive)`` runs ``drive`` on
rank 0 and ``follow`` elsewhere). A service built on a CUDA graph runs the CUDA
kernels through the engines, or raises; nothing falls back to the plain
versions on the card.
The per-layer read-out copies the live depth columns and the flushed
columns to the host (``msbfs_engine_readout``), as the reference's
``LayerReadout`` does; on a sharded service every rank gathers the
global rows and copies them.
"""
from __future__ import annotations

import contextlib
import threading
import time
import traceback
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.analytics.api import (AnalyticsAnswer, AnalyticsRequest,
                                       answer_request)
from repro_torch.analytics.closeness import (ClosenessResult,
                                             closeness_from_depths,
                                             select_sources)
from repro_torch.analytics.engine import LaneEngine
from repro_torch.analytics.khop import (BFSResult, ReachResult,
                                        khop_result_from_depth)
from repro_torch.analytics.meta import QueryMeta
from repro_torch.analytics.weighted import (SSSPDistancesResult,
                                            _resolve_delta)
from repro_torch.core.hybrid import ALPHA_DEFAULT, BETA_DEFAULT
from repro_torch.serving import frontdoor as fd
from repro_torch.serving.admission import (AdmissionController, DONE,
                                           QUEUED, REJECTED, RUNNING)
from repro_torch.serving.stats import summarize

__all__ = ["AnalyticsService", "RequestRecord", "ServiceConfig"]


@dataclass
class ServiceConfig:
    """Knobs of one service instance.

    ``slots``/``sssp_slots`` bound the per-epoch queue capacity of the
    packed / tropical pool (requests that don't fit wait for a recycle);
    ``max_pending``/``tenant_quota`` are the front-door bounds
    (``serving.admission``). ``delta`` pins the tropical engine's bucket
    width for the WHOLE service (the pool's state caches the light/heavy
    weights of its width) — sssp requests asking for a different width
    fall back to the inline batch path. ``streaming=False`` disables the
    mid-sweep read-outs (answers wait for lane flush). ``telemetry`` is
    a ``repro_torch.obs.Telemetry`` bundle: its registry backs
    ``service.metrics_text()`` and, when ``record_sweeps`` is on, every
    pool epoch records a per-layer ``SweepRecorder`` stream (None — the
    default — keeps the pools on the recorder-off fast path; a private
    registry still serves the request/sojourn metrics). ``slo`` is an
    optional ``repro_torch.obs.slo.SLOConfig`` — the service then runs an
    ``SLOMonitor`` fed per admission/answer/tick, and its health feeds
    ``health()['ready']`` (the /readyz bit).

    ``ndev > 1`` shards both pools over ``host_mesh(ndev)``; ``mesh`` (a
    1-D ``DeviceMesh``) shards them over that mesh, even of one rank."""
    lanes: int = 0               # packed pool width; 0 = adaptive
    slots: int = 256             # packed queue slots per epoch
    sssp_lanes: int = 0          # tropical pool width; 0 = engine default
    sssp_slots: int = 64         # tropical queue slots per epoch
    max_pending: int = 1024
    tenant_quota: int | None = None
    mode: str = "hybrid"
    probe_impl: str = "xla"
    alpha: float = ALPHA_DEFAULT
    beta: float = BETA_DEFAULT
    max_pos: int = 8
    ndev: int = 1
    delta: float | str | None = None
    streaming: bool = True
    telemetry: object = None     # repro_torch.obs.Telemetry (optional)
    slo: object = None           # repro_torch.obs.slo.SLOConfig (optional)
    mesh: object = None          # a 1-D DeviceMesh (optional)

    def __post_init__(self):
        if self.slots < 1 or self.sssp_slots < 1:
            raise ValueError(
                f"queue slots must be >= 1, got slots={self.slots} "
                f"sssp_slots={self.sssp_slots}")


@dataclass
class RequestRecord:
    """Service-side view of one request's lifecycle (returned by
    ``submit``; live object — fields update as the request advances)."""
    request: AnalyticsRequest
    status: str = QUEUED
    reason: str | None = None    # REJECTED only
    engine: str = ""             # "packed" | "tropical" | "batch"
    roots: np.ndarray | None = None
    slots: slice | None = None   # engine queue slots, set at dispatch
    submit_layer: int = 0
    dispatch_layer: int = -1
    answer_layer: int = -1
    answered_early: bool = False  # streamed mid-sweep, before lane flush
    answer: AnalyticsAnswer | None = None
    # kind-specific plan fields
    k: int = 0
    targets: np.ndarray | None = None
    cl_method: str = ""
    cl_seed: int | None = None
    delta: float | tuple | None = None

    @property
    def kind(self) -> str:
        return self.request.kind

    @property
    def sojourn(self) -> int:
        """Layers from submission to answer (-1 while unanswered)."""
        return (self.answer_layer - self.submit_layer
                if self.answer_layer >= 0 else -1)

    @property
    def lanes_used(self) -> int:
        return 0 if self.roots is None else int(self.roots.size)


class _PackedPool:
    """The packed MS-BFS engine behind one bounded queue of ``slots``
    root slots per epoch (on the graph's device, or 1-D sharded, chosen by
    the engine's partition)."""

    def __init__(self, svc: "AnalyticsService"):
        cfg, eng = svc.config, svc.engine
        from repro_torch.core.packed import adaptive_lane_pool
        self.slots = cfg.slots
        self.lanes = cfg.lanes or adaptive_lane_pool(cfg.slots, eng.n,
                                                     eng.m)
        self.slot_hi = 0
        self.state = None
        self.epochs = 0
        self._edges_done = 0
        self._kind = "bfs"
        self.recorder = None     # live epoch's SweepRecorder (or None)
        self._new_recorder = svc._sweep_recorder_factory(
            "dist_msbfs" if eng.dg is not None else "msbfs")
        if eng.dg is not None:
            from repro_torch.core import dist_msbfs as dm
            dg, mesh = eng.dg, eng.mesh
            self._init = lambda: dm.dist_msbfs_engine_init(
                dg, mesh, cfg.slots, self.lanes)
            self._enqueue = dm.dist_msbfs_engine_enqueue
            self._step = lambda s: dm.dist_msbfs_engine_step(
                dg, s, mesh, cfg.mode, cfg.alpha, cfg.beta, cfg.max_pos)
            self._idle = dm.dist_msbfs_engine_idle
            self._readout = lambda s: dm.dist_msbfs_engine_readout(dg, s)
            self._retire = lambda s, m: dm.dist_msbfs_engine_retire(
                dg, s, m)
            self._result = lambda s, p: dm.dist_msbfs_engine_result(
                dg, s, mesh, derive_parents=p)
        else:
            from repro_torch.core import msbfs as ms
            g = eng.g
            self._init = lambda: ms.msbfs_engine_init(
                g, capacity=cfg.slots, lanes=self.lanes)
            self._enqueue = ms.msbfs_engine_enqueue
            self._step = lambda s: ms.msbfs_engine_step(
                g, s, cfg.mode, cfg.alpha, cfg.beta, cfg.max_pos)
            self._idle = ms.msbfs_engine_idle
            self._readout = ms.msbfs_engine_readout
            self._retire = lambda s, m: ms.msbfs_engine_retire(g, s, m)
            self._result = lambda s, p: ms.msbfs_engine_result(
                g, s, derive_parents=p)

    def fits(self, k: int) -> bool:
        return self.slot_hi + k <= self.slots

    def enqueue(self, roots: np.ndarray) -> slice:
        if self.state is None:
            self.state = self._init()
            self.recorder = self._new_recorder()   # one stream per epoch
        lo = self.slot_hi
        self.state = self._enqueue(self.state, roots)
        self.slot_hi += int(roots.size)
        return slice(lo, self.slot_hi)

    def step(self) -> bool:
        if self.state is not None and not self._idle(self.state):
            if self.recorder is None:
                self.state = self._step(self.state)
            else:
                from repro_torch.obs.sweeplog import (record_step,
                                                      snapshot_state)
                pre = snapshot_state(self.state, self._kind)
                self.state = self._step(self.state)
                record_step(self.recorder, pre, self.state, self._kind)
            return True
        return False

    def idle(self) -> bool:
        return self.state is None or self._idle(self.state)

    def readout(self):
        return self._readout(self.state)

    def retire(self, lane_mask: np.ndarray) -> None:
        self.state = self._retire(self.state, lane_mask)

    def result(self, derive_parents: bool = False):
        """``MSBFSResult`` over the CURRENT epoch's answered slots (the
        validation surface — parents live here, not in the answers)."""
        if self.state is None:
            raise RuntimeError("packed pool has no live epoch")
        return self._result(self.state, derive_parents)

    def _edges_now(self) -> int:
        if self.state is None or self.slot_hi == 0:
            return 0
        return int(self.state.out_edges[:self.slot_hi].sum()) // 2

    def edges(self) -> int:
        """Undirected edges traversed across all epochs so far."""
        return self._edges_done + self._edges_now()

    def recycle(self) -> None:
        self._edges_done += self._edges_now()
        self.state = None
        self.recorder = None     # the telemetry bundle keeps the stream
        self.slot_hi = 0
        self.epochs += 1

    def active_lanes(self) -> int:
        if self.state is None:
            return 0
        return int((self.state.lane_qidx < self.state.capacity).sum())


class _TropicalPool:
    """The delta-stepping SSSP engine behind its own bounded queue.
    Delta is pinned per service; answers are collected at lane flush
    (``out_steps > 0``)."""

    def __init__(self, svc: "AnalyticsService"):
        cfg, eng = svc.config, svc.engine
        from repro_torch.traversal import sssp as ts
        self.slots = cfg.sssp_slots
        self.lanes = max(1, min(cfg.sssp_lanes or ts.DEFAULT_LANES,
                                cfg.sssp_slots))
        self.delta = svc.delta
        self.slot_hi = 0
        self.state = None
        self.epochs = 0
        self._steps_done = 0
        self._kind = "sssp"
        self.recorder = None
        self._new_recorder = svc._sweep_recorder_factory(
            "dist_sssp" if eng.dwg is not None else "sssp")
        if eng.dwg is not None:
            from repro_torch.core import dist_sssp as ds
            dwg, mesh = eng.dwg, eng.mesh
            self._trim = dwg.n_orig
            self._init = lambda: ds.dist_sssp_engine_init(
                dwg, mesh, cfg.sssp_slots, self.lanes)
            self._enqueue = ds.dist_sssp_engine_enqueue
            self._step = lambda s: ds.dist_sssp_engine_step(
                dwg, s, mesh, self.delta, cfg.max_pos, cfg.probe_impl)
            self._idle = ds.dist_sssp_engine_idle
        else:
            wg = eng.wg
            self._trim = eng.n
            self._init = lambda: ts.sssp_engine_init(
                wg, cfg.sssp_slots, self.lanes)
            self._enqueue = ts.sssp_engine_enqueue
            self._step = lambda s: ts.sssp_engine_step(
                wg, s, self.delta, cfg.max_pos, cfg.probe_impl)
            self._idle = ts.sssp_engine_idle

    def fits(self, k: int) -> bool:
        return self.slot_hi + k <= self.slots

    def enqueue(self, roots: np.ndarray) -> slice:
        if self.state is None:
            self.state = self._init()
            self.recorder = self._new_recorder()   # one stream per epoch
        lo = self.slot_hi
        self.state = self._enqueue(self.state, roots)
        self.slot_hi += int(roots.size)
        return slice(lo, self.slot_hi)

    def step(self) -> bool:
        if self.state is not None and not self._idle(self.state):
            if self.recorder is None:
                self.state = self._step(self.state)
            else:
                from repro_torch.obs.sweeplog import (record_step,
                                                      snapshot_state)
                pre = snapshot_state(self.state, self._kind)
                self.state = self._step(self.state)
                record_step(self.recorder, pre, self.state, self._kind)
            return True
        return False

    def idle(self) -> bool:
        return self.state is None or self._idle(self.state)

    def out_dist_cols(self, sl: slice) -> np.ndarray:
        """The answered slots' distance columns: sliced on the device,
        then copied to the host (replicated on a sharded engine: no
        collective)."""
        return self.state.out_dist[:self._trim, sl].cpu().numpy()

    def _steps_now(self) -> int:
        return 0 if self.state is None else int(self.state.sweep_steps)

    def steps(self) -> int:
        return self._steps_done + self._steps_now()

    def recycle(self) -> None:
        self._steps_done += self._steps_now()
        self.state = None
        self.recorder = None
        self.slot_hi = 0
        self.epochs += 1

    def active_lanes(self) -> int:
        if self.state is None:
            return 0
        return int((self.state.lane_qidx < self.state.capacity).sum())


# kinds that ride the packed pool as plain lane batches
_PACKED_KINDS = ("bfs", "khop", "reach", "closeness")


class AnalyticsService:
    """Async analytics server over one graph (see module docstring)."""

    def __init__(self, g, config: ServiceConfig | None = None, **overrides):
        if "grid" in overrides:
            raise ValueError(
                "the service's pools are 1-D only, as the reference's are: "
                "pass ndev= or a 1-D mesh=, not grid= (the 2-D engines "
                "serve offline queries through LaneEngine(grid=))")
        if config is None:
            config = ServiceConfig(**overrides)
        elif overrides:
            raise ValueError(
                f"pass a ServiceConfig OR overrides, not both — got "
                f"config plus {sorted(overrides)}")
        self.config = config
        self.telemetry = config.telemetry
        # metrics always work (metrics_text() on a bare service exposes
        # request/sojourn counters); sweep recording needs a telemetry
        # bundle with record_sweeps on
        if self.telemetry is not None:
            self._registry = self.telemetry.registry
        else:
            from repro_torch.obs.metrics import MetricsRegistry
            self._registry = MetricsRegistry()
        self.engine = LaneEngine(
            g, ndev=config.ndev, mesh=config.mesh,
            lanes=(config.lanes or None),
            mode=config.mode, alpha=config.alpha, beta=config.beta,
            max_pos=config.max_pos, probe_impl=config.probe_impl,
            telemetry=self.telemetry)   # inline batch sweeps record too
        # the partition the answers' metadata and the stats record
        self.ndev = self.engine.ndev
        # a sharded service's op channel from the mesh's first rank (the
        # front door) to the others; None on one device
        self._channel: fd.OpChannel | None = None
        if self.engine.dg is not None:
            import torch.distributed as dist
            members = self.engine.mesh.mesh.flatten().tolist()
            self._channel = fd.OpChannel(members,
                                         members.index(dist.get_rank()))
        self._outbox: list[RequestRecord] = []   # admitted since last op
        self._last_op = time.monotonic()
        # the service-wide tropical bucket width, resolved ONCE (the pool
        # runs every lane at it)
        self.delta = (_resolve_delta(self.engine, config.delta)
                      if self.engine.weighted else None)
        self._packed: _PackedPool | None = None
        self._tropical: _TropicalPool | None = None
        self._admission = AdmissionController(config.max_pending,
                                              config.tenant_quota)
        self._records: dict[str, RequestRecord] = {}
        self._pending: deque[RequestRecord] = deque()
        self._running: dict[str, list[RequestRecord]] = {
            "packed": [], "tropical": []}
        self._layer = 0
        self._wall = 0.0
        self._occupancy: list[int] = []
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._worker_error: BaseException | None = None
        if config.slo is not None:
            from repro_torch.obs.slo import SLOMonitor
            self.slo: SLOMonitor | None = SLOMonitor(config.slo,
                                                     self._registry)
        else:
            self.slo = None

    # -- telemetry ----------------------------------------------------------

    def _sweep_recorder_factory(self, engine_name: str):
        """Per-epoch recorder factory handed to the pools: each call is
        one fresh ``SweepRecorder`` stream (or None when the service has
        no telemetry bundle / sweep recording is off — the pools then
        never touch ``repro_torch.obs.sweeplog``)."""
        if self.telemetry is None:
            return lambda: None
        tel = self.telemetry
        return lambda: tel.recorder(engine_name, ndev=self.ndev,
                                    source="service")

    def metrics_text(self) -> str:
        """Prometheus text exposition of the service's registry (the
        telemetry bundle's registry when one was configured)."""
        from repro_torch.obs.metrics import metrics_text
        return metrics_text(self._registry)

    def trace_events(self) -> list:
        """Chrome trace-event list of every request lifecycle seen so
        far (QUEUED/RUNNING spans + early-readout markers on the layer
        clock), plus one process per recorded sweep when a telemetry
        bundle is recording — ready for ``obs.write_chrome_trace``."""
        from repro_torch.obs.traceviz import (service_trace_events,
                                        sweep_trace_events)
        with self._cv:
            events = service_trace_events(list(self._records.values()))
            sweeps = list(self.telemetry.sweeps) if self.telemetry else []
        for i, rec in enumerate(sweeps):
            events.extend(sweep_trace_events(rec, pid=10 + i))
        return events

    def _count_request(self, kind: str, status: str) -> None:
        self._registry.counter(
            "service_requests_total", "requests by admission outcome",
            ("kind", "status")).labels(kind=kind, status=status).inc()

    @property
    def _device(self) -> torch.device:
        """The graph's device: the pools' states and kernels live there."""
        return self.engine.g.device

    # -- planning -----------------------------------------------------------

    def _pool(self, name: str):
        if name == "packed":
            if self._packed is None:
                self._packed = _PackedPool(self)
            return self._packed
        if self._tropical is None:
            self._tropical = _TropicalPool(self)
        return self._tropical

    def _plan(self, rec: RequestRecord) -> None:
        """Classify the request: which engine, which lanes. Raises on
        requests the service cannot serve at all (invalid query /
        weighted workload on an unweighted graph)."""
        q = rec.request.query
        kind = rec.kind
        if kind == "sssp":
            if not self.engine.weighted:
                raise ValueError(
                    "sssp request on an unweighted service — build the "
                    "service from a WeightedCSRGraph (e.g. "
                    "graph.generator.rmat_weighted_graph)")
            rec.roots = np.asarray(q.sources, np.int32).reshape(-1)
            rec.delta = _resolve_delta(self.engine, q.delta)
            # a foreign delta would need its own pool — answer it inline
            # instead
            if (rec.delta == self.delta
                    and rec.roots.size <= self.config.sssp_slots):
                rec.engine = "tropical"
            else:
                rec.engine = "batch"
            return
        if kind in _PACKED_KINDS:
            if kind == "closeness":
                src, method = select_sources(self.engine.n, q.sources,
                                             q.seed)
                rec.roots = src
                rec.cl_method = method
                rec.cl_seed = None if method == "exact" else q.seed
            elif kind == "khop":
                if q.k < 0:
                    raise ValueError(f"k must be >= 0, got {q.k}")
                rec.roots = np.asarray(q.sources, np.int32).reshape(-1)
                rec.k = int(q.k)
            elif kind == "reach":
                rec.roots = np.asarray(q.sources, np.int32).reshape(-1)
                rec.targets = (rec.roots if q.targets is None
                               else np.asarray(q.targets,
                                               np.int32).reshape(-1))
            else:
                rec.roots = np.asarray(q.sources, np.int32).reshape(-1)
            if rec.roots.size < 1:
                raise ValueError("need at least one source")
            rec.engine = ("packed" if rec.roots.size <= self.config.slots
                          else "batch")
            return
        rec.engine = "batch"       # components / diameter / w-closeness

    # -- front door ---------------------------------------------------------

    def submit(self, request) -> RequestRecord:
        """Admit one request (an ``AnalyticsRequest`` or a bare query).
        Returns its live ``RequestRecord`` — status is ``QUEUED`` or
        ``REJECTED`` (with ``reason``) immediately; invalid requests
        raise instead of entering the lifecycle."""
        if not self.front_door:
            raise RuntimeError(
                "a sharded service's front door is rank 0 of its mesh: "
                "submit there, and run follow() on this rank")
        if not isinstance(request, AnalyticsRequest):
            request = AnalyticsRequest(query=request)
        with self._cv:
            if request.id in self._records:
                raise ValueError(f"duplicate request id {request.id!r}")
            rec = RequestRecord(request=request,
                                submit_layer=self._layer)
            self._plan(rec)
            self._admit(rec)
            if self._channel is not None:
                self._outbox.append(rec)
            self._cv.notify_all()
            return rec

    def _admit(self, rec: RequestRecord) -> None:
        """Admission and bookkeeping of a planned record (under the
        lock)."""
        ok, reason = self._admission.admit(rec.request.tenant)
        if not ok:
            rec.status = REJECTED
            rec.reason = reason
        else:
            self._pending.append(rec)
        self._count_request(rec.kind, rec.status)
        if self.slo is not None:
            self.slo.observe_admission(ok)
        self._records[rec.request.id] = rec

    def poll(self, request_id: str) -> str:
        """Lifecycle status of a request id."""
        with self._cv:
            return self._records[request_id].status

    def record(self, request_id: str) -> RequestRecord:
        with self._cv:
            return self._records[request_id]

    def result(self, request_id: str,
               timeout: float | None = None) -> AnalyticsAnswer:
        """Block until the request is answered; raises on rejection or
        timeout. With no worker thread running the caller must drive
        ``step()`` itself, so waiting would deadlock — that raises too."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            rec = self._records[request_id]
            while rec.status not in (DONE, REJECTED):
                if self._worker_error is not None:
                    raise RuntimeError(
                        f"service worker failed: "
                        f"{self._worker_error!r}") from self._worker_error
                if self._thread is None or not self._thread.is_alive():
                    raise RuntimeError(
                        "service has no worker thread — call start() "
                        "or drive step()/run_until_idle() directly")
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"request {request_id} still {rec.status} after "
                        f"{timeout}s")
                self._cv.wait(0.05 if remaining is None
                              else min(0.05, remaining))
            if rec.status == REJECTED:
                raise RuntimeError(
                    f"request {request_id} rejected: {rec.reason}")
            return rec.answer

    # -- scheduler ----------------------------------------------------------

    def busy(self) -> bool:
        with self._cv:
            return self._busy_locked()

    def _busy_locked(self) -> bool:
        return bool(self._pending or self._running["packed"]
                    or self._running["tropical"])

    def step(self) -> bool:
        """One scheduler tick: dispatch, advance both engines one layer,
        collect answers. Returns True while there is work in flight."""
        with self._cv:
            t0 = time.perf_counter()
            self._send(fd.STEP)
            return self._tick(t0)

    def _tick(self, t0: float) -> bool:
        """The tick's body (under the lock). On a sharded service every
        rank runs it on the same records, so the engines' collectives (the
        steps, the read-out's gathers, the inline batch sweeps) line up.
        ``t0`` starts the tick's wall time."""
        self._layer += 1
        self._dispatch()
        if self._packed is not None:
            self._packed.step()
        if self._tropical is not None:
            self._tropical.step()
        self._collect_packed()
        self._collect_tropical()
        occ = 0
        if self._packed is not None:
            occ += self._packed.active_lanes()
        if self._tropical is not None:
            occ += self._tropical.active_lanes()
        self._occupancy.append(occ)
        self._registry.counter(
            "service_layers_total", "scheduler ticks").inc()
        self._registry.gauge(
            "service_occupancy_lanes",
            "active engine lanes after the tick").set(occ)
        if self.slo is not None:
            self.slo.observe_queue_depth(self._admission.pending)
            self.slo.evaluate()
        self._wall += time.perf_counter() - t0
        self._cv.notify_all()
        return self._busy_locked()

    def _dispatch(self) -> None:
        still: deque[RequestRecord] = deque()
        blocked: set[str] = set()
        for rec in self._pending:
            if rec.engine == "batch":
                self._run_batch(rec)
                continue
            if rec.engine in blocked:
                still.append(rec)     # FIFO per engine: no overtaking
                continue
            pool = self._pool(rec.engine)
            if (not pool.fits(rec.roots.size)
                    and not self._running[rec.engine] and pool.idle()
                    and pool.slot_hi > 0):
                pool.recycle()        # drained epoch: slots go back to work
            if pool.fits(rec.roots.size):
                rec.slots = pool.enqueue(rec.roots)
                rec.status = RUNNING
                rec.dispatch_layer = self._layer
                self._running[rec.engine].append(rec)
                self._admission.on_dispatch(rec.request.tenant)
            else:
                blocked.add(rec.engine)
                still.append(rec)
        self._pending = still

    def _run_batch(self, rec: RequestRecord) -> None:
        """Inline path for whole-graph / foreign-delta workloads: the
        SAME ``answer_request`` the offline dispatcher uses."""
        rec.status = RUNNING
        rec.dispatch_layer = self._layer
        self._admission.on_dispatch(rec.request.tenant)
        self._finish(rec, answer_request(self.engine, rec.request),
                     early=False)

    def _finish(self, rec: RequestRecord, answer: AnalyticsAnswer,
                early: bool) -> None:
        rec.answer = answer
        rec.answer_layer = self._layer
        rec.answered_early = early
        rec.status = DONE
        self._admission.on_done(rec.request.tenant)
        self._registry.counter(
            "service_answers_total", "answers by kind",
            ("kind", "early")).labels(
                kind=rec.kind, early=str(early).lower()).inc()
        self._registry.histogram(
            "service_sojourn_layers", "submit-to-answer layers",
            ("kind",)).labels(kind=rec.kind).observe(rec.sojourn)
        if self.slo is not None:
            self.slo.observe_sojourn(rec.sojourn)

    # -- answer collection --------------------------------------------------

    def _collect_packed(self) -> None:
        running = self._running["packed"]
        if not running:
            return
        pool = self._packed
        ro = pool.readout()
        retire: list[int] = []
        for rec in running:
            got = self._try_answer_packed(rec, ro)
            if got is None:
                continue
            answer, early, live_lanes = got
            self._finish(rec, answer, early)
            retire.extend(live_lanes)
        if retire:
            mask = np.zeros(pool.lanes, bool)
            mask[retire] = True
            pool.retire(mask)
        self._running["packed"] = [r for r in running if r.status != DONE]

    def _try_answer_packed(self, rec: RequestRecord, ro):
        """(answer, answered_early, live_lanes_to_retire) when the
        request is answerable NOW, else None. Streamed answers read the
        live depth band (final by BFS depth monotonicity); flushed slots
        read their output columns."""
        sl = rec.slots
        out_ok = ro.out_layers[sl] > 0
        kind = rec.kind
        streaming = self.config.streaming
        if streaming and kind in ("khop", "reach"):
            cols, live, layers = [], [], 0
            for j, q in enumerate(range(sl.start, sl.stop)):
                if out_ok[j]:
                    cols.append(ro.out_depth[:, q])
                    layers = max(layers, int(ro.out_layers[q]))
                    continue
                lane = ro.lane_of_slot(q)
                if lane < 0:
                    return None           # still waiting in the queue
                col = ro.depth[:, lane]
                if kind == "khop":
                    if int(ro.lane_layer[lane]) < rec.k:
                        return None       # depth-k band not final yet
                else:
                    if not (col[rec.targets] >= 0).all():
                        return None       # some target still undiscovered
                cols.append(col)
                live.append(lane)
                layers = max(layers, int(ro.lane_layer[lane]))
            depth = np.stack(cols, axis=1)
            early = bool(live)
            meta = QueryMeta(
                kind=kind, layers=layers, lanes=rec.lanes_used,
                ndev=self.ndev,
                extra=(dict(depth_partial=early) if early else {}))
            if kind == "khop":
                res = khop_result_from_depth(rec.roots, rec.k, depth,
                                             meta)
            else:
                res = ReachResult(
                    sources=rec.roots, targets=rec.targets,
                    hops=depth[rec.targets].T.astype(np.int64), meta=meta)
            return (AnalyticsAnswer(rec.request.id, res, res.meta),
                    early, live)
        if not out_ok.all():
            return None                   # flush path: wait for every lane
        # a copy of the slots' columns: a view would keep the whole layer's
        # read-out (out_depth is [n, slots + 1]) alive with the answer
        depth = ro.out_depth[:, sl].copy()
        num_layers = ro.out_layers[sl].astype(np.int64)
        meta = QueryMeta(kind=kind, layers=int(num_layers.max()),
                         lanes=rec.lanes_used, ndev=self.ndev)
        if kind == "bfs":
            res = BFSResult(
                sources=rec.roots, depth=depth, num_layers=num_layers,
                reached=(depth >= 0).sum(axis=0).astype(np.int64),
                meta=meta)
        elif kind == "khop":
            res = khop_result_from_depth(rec.roots, rec.k, depth, meta)
        elif kind == "reach":
            res = ReachResult(sources=rec.roots, targets=rec.targets,
                              hops=depth[rec.targets].T.astype(np.int64),
                              meta=meta)
        else:
            c = closeness_from_depths(depth, self.engine.n)
            res = ClosenessResult(
                closeness=c, method=rec.cl_method,
                num_sources=int(rec.roots.size), seed=rec.cl_seed,
                meta=QueryMeta(kind="closeness",
                               layers=int(num_layers.max()),
                               lanes=rec.lanes_used,
                               ndev=self.ndev,
                               extra=dict(chunk=int(rec.roots.size))))
        return AnalyticsAnswer(rec.request.id, res, res.meta), False, []

    def _collect_tropical(self) -> None:
        running = self._running["tropical"]
        if not running:
            return
        pool = self._tropical
        out_steps = pool.state.out_steps
        out_trunc = pool.state.out_truncated
        for rec in running:
            sl = rec.slots
            steps = out_steps[sl]
            if not (steps > 0).all():
                continue
            trunc = out_trunc[sl]
            delta = (pool.delta if isinstance(pool.delta, tuple)
                     else float(pool.delta))
            res = SSSPDistancesResult(
                sources=rec.roots, dist=pool.out_dist_cols(sl),
                delta=delta, steps=steps.astype(np.int32),
                truncated_lanes=trunc,
                meta=QueryMeta(kind="sssp", layers=int(steps.max()),
                               truncated=bool(trunc.any()),
                               lanes=rec.lanes_used,
                               ndev=self.ndev,
                               extra=dict(grid=None, compress=False,
                                          delta=delta)))
            self._finish(rec, AnalyticsAnswer(rec.request.id, res,
                                              res.meta), early=False)
        self._running["tropical"] = [r for r in running
                                     if r.status != DONE]

    def packed_result(self, derive_parents: bool = False):
        """``MSBFSResult`` over the packed pool's CURRENT epoch — the
        validation surface (BFS-tree parents live here; answers carry
        depths only). Raises when the pool has no live epoch; note a
        recycled epoch's outputs are gone."""
        if self._packed is None:
            raise RuntimeError("service has served no packed requests")
        with self._cv:
            if self._packed.state is not None:
                self._send(fd.PACKED_RESULT, derive_parents)
            return self._packed.result(derive_parents)

    # -- drivers ------------------------------------------------------------

    def warmup(self, packed: bool = True,
               tropical: bool | None = None) -> None:
        """Step one throwaway engine state of each pool on the graph's
        device and wait for it, so the serving window measures traversal,
        not one-time set-up: on the card the first step builds the CUDA
        kernels (nvcc) and warms the allocator."""
        if tropical is None:
            tropical = self.engine.weighted
        with self._cv:
            self._send(fd.WARMUP, packed, tropical)
            self._warmup(packed, tropical)

    def _warmup(self, packed: bool, tropical: bool) -> None:
        if packed:
            pool = self._pool("packed")
            pool._step(pool._enqueue(pool._init(), np.zeros(1, np.int32)))
        if tropical:
            pool = self._pool("tropical")
            pool._step(pool._enqueue(pool._init(), np.zeros(1, np.int32)))
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def run_until_idle(self, max_layers: int = 100_000) -> dict:
        """Drive ``step()`` until every admitted request is DONE; returns
        ``stats()``."""
        while self.busy():
            self.step()
            if self._layer > max_layers:
                raise RuntimeError(
                    f"service still busy after {max_layers} layers — "
                    f"engine wedged or max_layers too small")
        return self.stats()

    def replay(self, trace, max_layers: int = 100_000) -> dict:
        """Replay a trace of ``AnalyticsRequest`` envelopes on the layer
        clock: requests become visible at their ``arrival`` tick, the
        service steps until drained. Returns ``stats()``."""
        trace = sorted(trace, key=lambda r: r.arrival)
        i = 0
        while i < len(trace) or self.busy():
            while i < len(trace) and trace[i].arrival <= self._layer:
                self.submit(trace[i])
                i += 1
            self.step()
            if self._layer > max_layers:
                raise RuntimeError(
                    f"replay still busy after {max_layers} layers")
        return self.stats()

    def stats(self) -> dict:
        with self._cv:
            packed = self._packed
            return summarize(
                list(self._records.values()), layers=self._layer,
                wall_s=self._wall,
                edges=packed.edges() if packed else 0,
                lanes=packed.lanes if packed else (self.config.lanes or 0),
                ndev=self.ndev, occupancy=self._occupancy,
                sssp_steps=(self._tropical.steps()
                            if self._tropical else 0),
                delta=(None if self._tropical is None else
                       (self.delta if isinstance(self.delta, tuple)
                        else float(self.delta))))

    # -- health -------------------------------------------------------------

    def worker_alive(self) -> bool:
        """True while the background worker thread is up and not asked
        to stop. Lock-free — safe to call from a liveness probe even
        while a long engine layer holds the scheduler lock. A worker that
        raised is dead: its exception shows in ``health()['error']``."""
        t = self._thread
        return t is not None and t.is_alive() and not self._stopping

    def health(self) -> dict:
        """JSON-ready liveness + readiness view (the /healthz and
        /readyz payload). Deliberately lock-free: every field is a
        single-attribute read or an SLO ``peek()`` (non-mutating), so a
        health probe never waits on the scheduler lock."""
        alive = self.worker_alive()
        depth = self._admission.pending
        queue_ok = depth < self.config.max_pending
        out = dict(alive=alive, stopping=self._stopping,
                   queue_depth=depth,
                   max_pending=self.config.max_pending,
                   queue_ok=queue_ok, layer=self._layer)
        slo_ok = True
        if self.slo is not None:
            out["slo"] = snap = self.slo.peek()
            slo_ok = snap["healthy"]
        if self._worker_error is not None:
            out["error"] = repr(self._worker_error)
        out["ready"] = bool(alive and queue_ok and slo_ok)
        return out

    # -- worker thread ------------------------------------------------------

    def start(self) -> "AnalyticsService":
        """Start the background worker: steps whenever work is in
        flight, sleeps otherwise. Idempotent."""
        with self._cv:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stopping = False
            self._worker_error = None
            self._thread = threading.Thread(
                target=self._serve_loop, name="analytics-service",
                daemon=True)
            self._thread.start()
        return self

    def _serve_loop(self) -> None:
        # the engines allocate on the current CUDA device: pin the graph's
        guard = (torch.cuda.device(self._device)
                 if self._device.type == "cuda" else contextlib.nullcontext())
        with guard:
            while True:
                with self._cv:
                    while not self._stopping and not self._busy_locked():
                        self._cv.wait(0.05)
                        if (self._channel is not None and not self._stopping
                                and time.monotonic() - self._last_op
                                >= fd.HEARTBEAT_S):
                            self._send(fd.HEARTBEAT)
                    if self._stopping:
                        return
                try:
                    self.step()
                except BaseException as e:
                    # the worker dies with its exception: health() and
                    # result() report it, the thread's excepthook prints
                    # it, a sharded service's followers get the error op
                    with self._cv:
                        self._worker_error = e
                        self._cv.notify_all()
                    if self._channel is not None:
                        self._channel.abandon(traceback.format_exc())
                    raise

    def stop(self) -> None:
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None

    # -- SPMD ranks ---------------------------------------------------------

    @property
    def front_door(self) -> bool:
        """True on the rank that takes requests: the only rank of a
        one-device service, rank 0 of a sharded service's mesh."""
        return self._channel is None or self._channel.front

    def _send(self, op: str, *args) -> None:
        """Broadcast one op record to the followers (under the lock): the
        op, its arguments, and the records admitted since the last op. A
        no-op on one device; a follower must not drive the service."""
        if self._channel is None:
            return
        if not self._channel.front:
            raise RuntimeError(
                "this rank follows the service's front door (rank 0 of its "
                "mesh): run follow() here, and drive the service there")
        records, self._outbox = self._outbox, []
        self._channel.send(op, args, records)
        self._last_op = time.monotonic()

    def follow(self) -> None:
        """Serve as a follower of a sharded service (ranks > 0 of its
        mesh): apply the front door's op records and run the same ops, so
        every collective of the engines lines up, until the stop op
        arrives. Raises with the front door's traceback on the error op."""
        if self.front_door:
            raise RuntimeError(
                "follow() runs on the ranks > 0 of a sharded service's mesh; "
                "this rank is the front door")
        while True:
            op, args, records = self._channel.recv()
            with self._cv:
                for rec in records:
                    want, reason = rec.status, rec.reason
                    rec.status, rec.reason = QUEUED, None
                    self._admit(rec)
                    if (rec.status, rec.reason) != (want, reason):
                        raise RuntimeError(
                            f"request {rec.request.id}: this rank admitted "
                            f"it as {rec.status}, the front door as {want}")
                if op == fd.STOP:
                    return
                if op == fd.ERROR:
                    raise RuntimeError(
                        f"the service's front door (rank "
                        f"{self._channel.src}) failed:\n{args[0]}")
                if op == fd.STEP:
                    self._tick(time.perf_counter())
                elif op == fd.WARMUP:
                    self._warmup(*args)
                elif op == fd.PACKED_RESULT:
                    self._packed.result(*args)
                elif op != fd.HEARTBEAT:
                    raise RuntimeError(f"unknown service op {op!r}")

    def close(self, error: str | None = None) -> None:
        """Stop the worker and, on a sharded service's front door, release
        the followers: the stop op (their ``follow()`` returns), or the
        error op carrying ``error`` (they raise with it). Idempotent; a
        no-op on a follower and, but for the worker, on one device."""
        self.stop()
        ch = self._channel
        if ch is None or not ch.front or ch.closed:
            return
        if error is not None:
            ch.abandon(error)
            return
        with self._cv:
            self._send(fd.STOP)

    def lead(self, drive):
        """Run ``drive`` on the ranks of a service: ``drive(self)`` on the
        front door, then ``close()``; ``follow()`` on the other ranks of a
        sharded service. Returns ``drive``'s value on the front door and
        None elsewhere. A ``drive`` that raises sends the error op."""
        if not self.front_door:
            self.follow()
            return None
        try:
            out = drive(self)
        except BaseException:
            self.close(error=traceback.format_exc())
            raise
        self.close()
        return out

    def __enter__(self) -> "AnalyticsService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
