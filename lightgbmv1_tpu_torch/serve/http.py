"""Stdlib HTTP front-end over :class:`~lightgbmv1_tpu_torch.serve.Server`
or a fleet's :class:`~lightgbmv1_tpu_torch.serve.Router` (the same calls:
``submit``, ``health``, ``metrics``, ``metrics_snapshot``,
``slo_snapshot``, ``drift_snapshot``, ``tenants_snapshot``); the port's
copy of lightgbmv1_tpu/serve/http.py.

``http.server`` and ``json`` only: a handler thread decodes the rows,
blocks in ``Server.submit()`` like any in-process caller (so HTTP
requests micro-batch together with direct callers), and maps the
outcome onto a status code: 200 scored, 400 malformed input (bad JSON,
a body that is not an object, missing or empty ``rows``, non-numeric
cells, the wrong feature count), 404 an unknown route or tenant, 503
shed / stalled / closed / not yet published, 504 deadline expired, and
a structured 500 for anything unexpected — never a traceback page.

Endpoints:

* ``POST /predict``  body ``{"rows": [[...], ...]}`` (and optionally
  ``"tenant"``) -> ``{"values": [[...], ...], "version": "v2",
  "degraded": false, "latency_ms": 1.9, "trace_id": "...", "queue_ms",
  "walk_ms"}``.  Every response carries an ``X-Trace-Id`` header: the
  inbound one when the client sent it, else a fresh id, which rides the
  request through the queue, the batch and the walk.
* ``GET /metrics``   the JSON ``ServeMetrics`` snapshot, or Prometheus
  text with ``Accept: text/plain`` or ``?format=prometheus`` (one
  store: obs/metrics.py).
* ``GET /slo``       burn rates, alerts and exemplar trace ids
  (serve/slo.py); ``?tenant=`` for one tenant.
* ``GET /drift``     the active version's train/serve skew
  (obs/drift.py), or ``armed: false`` with a reason; ``?tenant=``.
* ``GET /tenants``   every tenant's version, fair share, occupancy and
  outcomes.
* ``GET /healthz``   200 only while the dispatcher is alive, not wedged
  and a model is published; 503 otherwise.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .server import (DEFAULT_TENANT, DispatcherStalled, RequestTimeout,
                     ServeError, Server, ServerClosed, ServerOverloaded,
                     UnknownTenant)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _query_param(query: str, key: str) -> str:
    """Minimal query-string lookup (no urllib dependency creep for one
    scalar): last ``key=value`` pair wins, '' when absent."""
    out = ""
    for part in query.split("&"):
        if part.startswith(key + "="):
            out = part[len(key) + 1:]
    return out


def _make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: A003 — silence stderr
            pass

        def _reply(self, code: int, payload: dict,
                   headers: dict = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code: int, text: str,
                        content_type: str) -> None:
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _wants_prometheus(self) -> bool:
            if "format=prometheus" in (self.path.split("?", 1) + [""])[1]:
                return True
            accept = self.headers.get("Accept", "")
            return "text/plain" in accept or "openmetrics" in accept

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            route, query = (self.path.split("?", 1) + [""])[:2]
            tenant = _query_param(query, "tenant")
            try:
                if route == "/metrics":
                    if self._wants_prometheus():
                        # exemplar suffixes only for OpenMetrics
                        # consumers — they are not part of the 0.0.4
                        # text grammar
                        om = "openmetrics" in self.headers.get(
                            "Accept", "")
                        self._reply_text(
                            200,
                            server.metrics.prometheus_text(exemplars=om),
                            PROM_CONTENT_TYPE)
                    else:
                        self._reply(200, server.metrics_snapshot())
                elif route == "/slo":
                    # burn-rate evaluation + worst-tail exemplar trace
                    # ids (serve/slo.py) — the page/warn booleans an
                    # external alerter can poll without scraping
                    # histograms; ?tenant= narrows to one lineage
                    self._reply(200, server.slo_snapshot(
                        tenant=tenant) if tenant
                        else server.slo_snapshot())
                elif route == "/drift":
                    # train/serve skew evaluation (obs/drift.py):
                    # per-feature PSI vs the active version's training
                    # reference, skew counters and score drift —
                    # computed on READ, never on the serving path;
                    # ?tenant= narrows to that tenant's detector
                    self._reply(200, server.drift_snapshot(
                        tenant=tenant) if tenant
                        else server.drift_snapshot())
                elif route == "/tenants":
                    # the multi-tenant control surface: per-tenant
                    # version, fair-share occupancy, shed/error counts
                    # and SLO page/burn summary (serve/server.py
                    # tenants_snapshot; on a router, per-replica views
                    # plus the placement map)
                    self._reply(200, server.tenants_snapshot())
                elif route == "/healthz":
                    health = server.health()
                    self._reply(200 if health["ok"] else 503, health)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})
            except UnknownTenant as e:
                self._reply(404, {"error": str(e), "tenant": tenant})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            from ..obs import trace as _trace

            trace_id = (self.headers.get("X-Trace-Id", "").strip()
                        or _trace.new_trace_id())
            tid_hdr = {"X-Trace-Id": trace_id}
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError(
                        f"body must be a JSON object, got "
                        f"{type(req).__name__}")
                rows = req["rows"]
                if not isinstance(rows, list) or not rows:
                    raise ValueError("'rows' must be a non-empty list")
                tenant = req.get("tenant", DEFAULT_TENANT)
                if not isinstance(tenant, str):
                    raise ValueError("'tenant' must be a string")
            except KeyError as e:
                self._reply(400, {"error": f"missing field {e}"},
                            headers=tid_hdr)
                return
            except (ValueError, TypeError) as e:
                self._reply(400, {"error": f"bad request body: {e}"},
                            headers=tid_hdr)
                return
            try:
                res = server.submit(rows, trace_id=trace_id,
                                    tenant=tenant)
            except UnknownTenant as e:
                # the lineage does not exist — routing elsewhere cannot
                # create it, so this is the caller's 404, not a 503
                self._reply(404, {"error": str(e), "tenant": tenant},
                            headers=tid_hdr)
                return
            except ServerOverloaded as e:
                self._reply(503, {"error": str(e), "shed": True},
                            headers=tid_hdr)
                return
            except RequestTimeout as e:
                self._reply(504, {"error": str(e), "timeout": True},
                            headers=tid_hdr)
                return
            except (DispatcherStalled, ServerClosed) as e:
                # retryable-elsewhere: the replica is wedged or draining
                self._reply(503, {"error": f"{type(e).__name__}: {e}"},
                            headers=tid_hdr)
                return
            except (ValueError, TypeError) as e:
                # client-input failures from row coercion/shape checks
                # (non-numeric cells, wrong feature count, ragged rows)
                self._reply(400, {"error": f"{type(e).__name__}: {e}"},
                            headers=tid_hdr)
                return
            except ServeError as e:
                self._reply(503, {"error": f"{type(e).__name__}: {e}"},
                            headers=tid_hdr)
                return
            except RuntimeError as e:
                # e.g. "no model published yet" — not ready, not a bug
                self._reply(503, {"error": str(e)}, headers=tid_hdr)
                return
            except Exception as e:  # noqa: BLE001 — structured 500, not
                # an unhandled-traceback page
                self._reply(500, {"error": f"{type(e).__name__}: {e}"},
                            headers=tid_hdr)
                return
            payload = {
                "values": res.values.tolist(),
                "version": res.version,
                "degraded": res.degraded,
                "latency_ms": round(res.latency_ms, 3),
                "trace_id": res.trace_id,
                "queue_ms": round(res.queue_ms, 3),
                "walk_ms": round(res.walk_ms, 3),
            }
            if tenant:
                payload["tenant"] = tenant
            self._reply(200, payload, headers=tid_hdr)

    return Handler


class ServeHTTP:
    """Threaded HTTP listener bound to ``(host, port)``; ``port=0`` picks
    an ephemeral port (read it back from ``.port``)."""

    def __init__(self, server: Server, host: str = "127.0.0.1",
                 port: int = 0):
        self.server = server
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_handler(server))
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="serve-http", daemon=True)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "ServeHTTP":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
