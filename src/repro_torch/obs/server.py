"""ObservabilityServer — the live HTTP plane over a running service (port
of ``repro.obs.server``, copied).

Everything the stack already measures becomes reachable from OUTSIDE the
process, with zero dependencies beyond the stdlib ``http.server``:

====================  ======================================================
``GET /metrics``      Prometheus text scrape of the service registry
                      (``AnalyticsService.metrics_text``)
``GET /healthz``      liveness: worker thread up and not stopping
                      (200/503 + JSON detail; lock-free read path, so a
                      probe never blocks behind a long engine layer)
``GET /readyz``       readiness: healthz AND queue depth within
                      ``max_pending`` AND every configured SLO holding
``GET /debug/sweeps``   recorded sweep summaries (``Telemetry.sweeps``;
                      ``?full=1`` inlines the per-layer records)
``GET /debug/requests`` every request record's lifecycle view
``POST /v1/submit``   submit an ``AnalyticsRequest`` wire envelope
``GET /v1/poll/{id}`` lifecycle status of one request
``GET /v1/result/{id}`` the full answer as a wire envelope
                      (``to_wire(include_result=True)`` — decodes
                      BIT-identical to the in-process answer; 202 while
                      pending, 409 when rejected)
====================  ======================================================

The submit/poll/result routes ride the SAME ``AnalyticsRequest``/``AnalyticsAnswer``
envelopes as the in-process API, so a remote client sees exactly what
``run_query`` returns. The server wraps an already-``start()``-ed
service — it never drives ``step()`` itself::

    with AnalyticsService(g, telemetry=tel) as svc:
        with ObservabilityServer(svc) as obs:
            print(obs.url)           # http://127.0.0.1:<port>
            ...                      # curl away

Every handled request bumps ``http_requests_total{path, code}`` on the
service registry (paths normalized — ids stripped — so the label set
stays bounded).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["ObservabilityServer"]

# normalized path label values (bounded metric cardinality)
_ROUTES = ("/metrics", "/healthz", "/readyz", "/debug/sweeps",
           "/debug/requests", "/v1/submit", "/v1/poll", "/v1/result")


def _route_label(path: str) -> str:
    for r in _ROUTES:
        if path == r or path.startswith(r + "/"):
            return r
    return "other"


def _request_view(rec) -> dict:
    """JSON-ready lifecycle view of one ``RequestRecord``."""
    return dict(
        id=rec.request.id, kind=rec.kind, tenant=rec.request.tenant,
        status=rec.status, reason=rec.reason, engine=rec.engine,
        lanes=rec.lanes_used, submit_layer=rec.submit_layer,
        dispatch_layer=rec.dispatch_layer, answer_layer=rec.answer_layer,
        sojourn=rec.sojourn, answered_early=rec.answered_early)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "repro-obs/1"

    # the wrapping ObservabilityServer; set on the subclass at build time
    obs: "ObservabilityServer" = None

    def log_message(self, *args):     # no stderr chatter per request
        pass

    # -- plumbing ---------------------------------------------------------

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        self.obs._count(_route_label(self.path), code)

    def _json(self, code: int, payload) -> None:
        self._send(code, json.dumps(payload).encode(),
                   "application/json")

    def _text(self, code: int, text: str) -> None:
        self._send(code, text.encode(),
                   "text/plain; version=0.0.4; charset=utf-8")

    # -- routes -----------------------------------------------------------

    def do_GET(self):
        svc = self.obs.service
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._text(200, svc.metrics_text())
            elif path == "/healthz":
                h = svc.health()
                self._json(200 if h["alive"] else 503, h)
            elif path == "/readyz":
                h = svc.health()
                self._json(200 if h["ready"] else 503, h)
            elif path == "/debug/sweeps":
                full = "full=1" in (self.path.split("?", 1) + [""])[1]
                self._json(200, self.obs._sweeps_view(full))
            elif path == "/debug/requests":
                with svc._cv:
                    views = [_request_view(r)
                             for r in svc._records.values()]
                self._json(200, views)
            elif path.startswith("/v1/poll/"):
                self._poll(path[len("/v1/poll/"):])
            elif path.startswith("/v1/result/"):
                self._result(path[len("/v1/result/"):])
            else:
                self._json(404, dict(error=f"no route {path!r}"))
        except Exception as e:          # noqa: BLE001 — server must live
            self._json(500, dict(error=f"{type(e).__name__}: {e}"))

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        try:
            if path == "/v1/submit":
                self._submit()
            else:
                self._json(404, dict(error=f"no route {path!r}"))
        except Exception as e:          # noqa: BLE001
            self._json(500, dict(error=f"{type(e).__name__}: {e}"))

    # -- wire transport ---------------------------------------------------

    def _submit(self) -> None:
        from repro_torch.analytics.api import AnalyticsRequest
        length = int(self.headers.get("Content-Length", 0))
        try:
            wire = json.loads(self.rfile.read(length) or b"")
            request = AnalyticsRequest.from_wire(wire)
        except (ValueError, TypeError) as e:
            self._json(400, dict(error=str(e)))
            return
        try:
            rec = self.obs.service.submit(request)
        except (ValueError, TypeError) as e:
            self._json(400, dict(error=str(e)))
            return
        self._json(200, dict(id=rec.request.id, kind=rec.kind,
                             status=rec.status, reason=rec.reason))

    def _find(self, request_id: str):
        svc = self.obs.service
        with svc._cv:
            return svc._records.get(request_id)

    def _poll(self, request_id: str) -> None:
        rec = self._find(request_id)
        if rec is None:
            self._json(404, dict(error=f"unknown request {request_id!r}"))
            return
        self._json(200, dict(id=request_id, status=rec.status,
                             reason=rec.reason))

    def _result(self, request_id: str) -> None:
        from repro_torch.serving.admission import DONE, REJECTED
        rec = self._find(request_id)
        if rec is None:
            self._json(404, dict(error=f"unknown request {request_id!r}"))
            return
        if rec.status == REJECTED:
            self._json(409, dict(id=request_id, status=rec.status,
                                 reason=rec.reason))
        elif rec.status != DONE:
            self._json(202, dict(id=request_id, status=rec.status))
        else:
            self._json(200, rec.answer.to_wire(include_result=True))


class ObservabilityServer:
    """HTTP observability + wire-transport plane over one running
    ``AnalyticsService`` (see module docstring for the routes).

    ``port=0`` (the default) binds an OS-assigned free port — read it
    back from ``.port`` / ``.url``. The server runs on a daemon thread
    (one more per in-flight request, ``ThreadingHTTPServer``); it never
    steps the service, so start the worker (``service.start()``) or
    drive ``step()`` yourself for submitted work to finish."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        handler = type("_BoundHandler", (_Handler,), {"obs": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    # -- metrics ----------------------------------------------------------

    def _count(self, path: str, code: int) -> None:
        self.service._registry.counter(
            "http_requests_total", "observability HTTP requests",
            ("path", "code")).labels(path=path, code=str(code)).inc()

    def _sweeps_view(self, full: bool) -> list:
        tel = self.service.telemetry
        if tel is None:
            return []
        out = []
        for rec in list(tel.sweeps):
            view = rec.summary()
            if full:
                view["records"] = [r.as_dict() for r in rec.records]
            out.append(view)
        return out

    # -- lifecycle --------------------------------------------------------

    @property
    def host(self) -> str:
        return self._httpd.server_address[0]

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ObservabilityServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="obs-http",
                daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def __enter__(self) -> "ObservabilityServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
