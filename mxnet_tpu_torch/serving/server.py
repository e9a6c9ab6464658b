"""Stdlib HTTP front door for the serving tier.

The counterpart of ``mxnet_tpu/serving/server.py``.  Endpoints:

* ``POST /predict``: body ``{"<input>": <nested list>, ...}`` plus an
  optional ``"deadline_ms"``; every other key is a model input (rows along
  axis 0; one unbatched row is accepted).  Replies 200
  ``{"outputs": [...], "rows": N, "wall_ms": W}``, 503 ``{"shed": reason,
  "rid": n, "trace_id": t}`` when the load shedder refused the request,
  400 for a bad body, 500 ``{"error": msg}`` when the dispatch failed.
  An inbound ``traceparent`` continues the caller's trace, and every reply
  carries ``X-Trace-Id`` and ``traceparent``;
* ``GET /healthz``: 200 with the ladder and queue state while the batcher
  runs, 503 once it stopped.  ``?deep=1`` embeds the SLO engine's
  ``mxtpu-health/1`` verdict and answers 503 when it is ``critical``;
* ``GET /alerts``: the verdict and every rule's state;
* ``GET /metrics``: the Prometheus exposition (``telemetry.render_prom``).

Constructing a :class:`Server` configures the SLO engine's queue-depth rule
from the batcher and starts its ticker, as the JAX server does.
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..base import MXNetError
from ..telemetry import tracing
from .batcher import Batcher, RequestShed

__all__ = ["Server", "serve_port"]


def serve_port(port=None):
    """The replica's port: explicit ``port``, else
    ``MXNET_TPU_SERVE_PORT``, offset by the replica's rank
    (``MXNET_TPU_PROCESS_ID``) so co-located replicas never race for
    one bind.  Port 0 (an ephemeral port) takes no offset."""
    if port is None:
        try:
            port = int(os.environ.get("MXNET_TPU_SERVE_PORT", "8080"))
        except ValueError:
            port = 8080
    try:
        rank = int(os.environ.get("MXNET_TPU_PROCESS_ID", "0"))
    except ValueError:
        rank = 0
    return port + rank if port > 0 else port


class Server:
    """HTTP server over a :class:`~mxnet_tpu_torch.serving.batcher.Batcher`.

    ``batcher=None`` builds one from ``ladder`` with its defaults.
    ``port=None`` binds :func:`serve_port`; ``port=0`` an ephemeral port
    (read it back from :attr:`port`).  The HTTP threads only call
    ``batcher.submit``; the model runs on the batcher's scheduler
    thread."""

    def __init__(self, ladder, batcher=None, port=None, host="0.0.0.0"):
        self._ladder = ladder
        self._batcher = batcher or Batcher(ladder)
        self._httpd = self._build(host, serve_port(port))
        self._thread = None
        # arm the SLO judge: the replica evaluates its serving rules on
        # a background ticker and the queue-depth rule learns the
        # batcher's REAL capacity
        from ..telemetry import slo
        if slo.enabled():
            slo.engine().configure(
                "serve_queue_depth",
                bound=0.9 * getattr(self._batcher, "_depth", 64))
            slo.start_ticker()

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def batcher(self):
        return self._batcher

    def start(self):
        """Serve from a daemon thread."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="mxtt-serve-http")
            self._thread.start()
        return self

    def serve_forever(self):
        """Serve on the calling thread."""
        self._httpd.serve_forever()

    def close(self):
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(5.0)
        self._httpd.server_close()
        self._batcher.close()

    def _build(self, host, port):
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def _send(self, doc, status=200,
                      ctype="application/json", trace=None):
                body = doc if isinstance(doc, bytes) else \
                    json.dumps(doc).encode("utf-8")
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                if trace is not None and trace.ctx is not None:
                    # propagation contract: every /predict reply names
                    # its trace, so a slow or shed reply is joinable to
                    # the exported trace record
                    self.send_header("X-Trace-Id", trace.trace_id)
                    self.send_header("traceparent",
                                     trace.ctx.to_traceparent())
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                parsed = urlparse(self.path)
                path = parsed.path.rstrip("/") or "/"
                if path in ("/", "/healthz"):
                    ok = server._batcher.alive
                    doc = {
                        "status": "ok" if ok else "stopped",
                        "pid": os.getpid(),
                        "queue_depth": server._batcher.queue_depth(),
                        "ladder": server._ladder.describe(),
                    }
                    status = 200 if ok else 503
                    q = parse_qs(parsed.query)
                    if q.get("deep", ["0"])[-1] not in ("", "0",
                                                        "false"):
                        from ..telemetry import slo
                        verdict = slo.health()
                        doc["health"] = verdict
                        doc["status"] = "stopped" if not ok else \
                            verdict["status"]
                        # critical = the error budget is burning: a
                        # fleet supervisor / LB drains this replica
                        if verdict["status"] == "critical":
                            status = 503
                    self._send(doc, status=status)
                    return
                if path == "/alerts":
                    from ..telemetry import slo
                    doc = slo.health()
                    doc["alerts"] = slo.engine().alerts() \
                        if slo.enabled() else []
                    self._send(doc)
                    return
                if path == "/metrics":
                    from ..telemetry import render_prom
                    self._send(render_prom().encode("utf-8"),
                               ctype="text/plain; version=0.0.4; "
                                     "charset=utf-8")
                    return
                self.send_error(404)

            def do_POST(self):
                if self.path.rstrip("/") != "/predict":
                    self.send_error(404)
                    return
                t0 = time.perf_counter()
                # one trace per request; an inbound traceparent header
                # continues the caller's trace (NULL_TRACE when off)
                tr = tracing.start_trace(
                    "serve.request",
                    traceparent=self.headers.get("traceparent"))
                with tr:
                    try:
                        n = int(self.headers.get("Content-Length", "0"))
                        doc = json.loads(self.rfile.read(n) or b"{}")
                        if not isinstance(doc, dict):
                            raise MXNetError(
                                "predict body must be a JSON object of "
                                "model inputs")
                        deadline_ms = doc.pop("deadline_ms", None)
                        outs = server._batcher.submit(
                            doc, deadline_ms=deadline_ms)
                    except RequestShed as e:
                        tr.set_status("shed", shed_reason=e.reason)
                        body = {"shed": e.reason, "error": str(e)}
                        if e.rid is not None:
                            body["rid"] = e.rid
                        if tr.trace_id is not None:
                            body["trace_id"] = tr.trace_id
                        self._send(body, status=503, trace=tr)
                        return
                    except Exception as e:  # every failure answers 4xx/5xx instead of dropping the connection
                        tr.set_status("error", error=str(e)[:200])
                        status = 400 if isinstance(
                            e, (ValueError, KeyError)) else 500
                        self._send({"error": str(e)[:500]},
                                   status=status, trace=tr)
                        return
                    rows = int(np.asarray(outs[0]).shape[0]) \
                        if outs else 0
                    tr.annotate(rows=rows)
                    self._send({
                        "outputs": [np.asarray(o).tolist()
                                    for o in outs],
                        "rows": rows,
                        "wall_ms": round(
                            (time.perf_counter() - t0) * 1e3, 3),
                    }, trace=tr)

            def log_message(self, fmt, *args):
                pass

        return ThreadingHTTPServer((host, int(port)), _Handler)
