"""The admin endpoint: a stdlib HTTP surface over a running Server.

A fleet scheduler (or an operator with ``curl``) reads a serving process
without attaching a debugger:

    GET /healthz   -> 200/503  is every serving thread running?
    GET /readyz    -> 200/503  ...and can it take traffic right now
                               (every bound view's graphs captured)?
    GET /metrics   -> Prometheus text exposition (every registry the
                      server touches: global + per-program + pool)
    GET /statusz   -> JSON: Server.stats(verbose=True) + per-program
                      fused-segment roster + plan-cache + SLO state +
                      the recent structured-log tail
                      (?format=text renders serve.format_stats instead)
    GET /tracez    -> an on-demand flight-recorder dump (the same
                      Chrome-trace JSON scripts/check_trace.py --flight
                      validates); 503 when no recorder is installed

Zero new dependencies: ``http.server.ThreadingHTTPServer`` with daemon
request threads. Bound to loopback by default (``ServeConfig(
admin_host=)``) — the endpoint exposes operational detail, not user
data, but there is no auth layer, so keep it off public interfaces.

Lifecycle: ``Server.start`` constructs and starts one ``AdminServer``
when ``ServeConfig(admin_port=)`` is set (``0`` = ephemeral, read
``server.admin.port``); ``Server.stop`` shuts it down *after* the
serving threads so a probe during drain observes "unhealthy" instead
of a connection refused that looks like a dead host. The acceptor
thread is joined in :meth:`AdminServer.stop`.

Every route runs on a request thread of the same interpreter as the
serving threads; nothing here touches a tensor.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from repro_torch import obs


class AdminServer:
    """One HTTP acceptor thread serving the ops routes for ``server``."""

    def __init__(self, server, port: int = 0, host: str = "127.0.0.1"):
        self._server = server
        handler = _make_handler(server)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "AdminServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="repro-torch-serve-admin",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: Optional[float] = None) -> None:
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout)
        self._httpd.server_close()


def _make_handler(server):
    """A handler class closed over the Server (BaseHTTPRequestHandler is
    instantiated per request by the HTTP server, so state rides the
    closure, not the instance)."""

    class Handler(BaseHTTPRequestHandler):

        # ops probes arrive every few seconds; stderr access logging
        # would drown the structured log
        def log_message(self, fmt, *args):  # noqa: A003
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, payload) -> None:
            self._send(code, json.dumps(payload, default=str).encode(),
                       "application/json")

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            parsed = urlparse(self.path)
            route = parsed.path.rstrip("/") or "/"
            try:
                if route == "/metrics":
                    self._send(200, server.prometheus_metrics().encode(),
                               "text/plain; version=0.0.4")
                elif route == "/healthz":
                    h = server.health()
                    self._send_json(200 if h["healthy"] else 503, h)
                elif route == "/readyz":
                    r = server.readiness()
                    self._send_json(200 if r["ready"] else 503, r)
                elif route == "/statusz":
                    self._statusz(parsed)
                elif route == "/tracez":
                    fl = obs.get_flight()
                    if fl is None:
                        self._send_json(503, {
                            "error": "no flight recorder installed "
                                     "(obs.uninstall() was called)"})
                    else:
                        self._send_json(200, fl.dump(reason="tracez"))
                else:
                    self._send_json(404, {
                        "error": f"unknown route {route!r}",
                        "routes": ["/metrics", "/healthz", "/readyz",
                                   "/statusz", "/tracez"]})
            except Exception as e:  # noqa: BLE001 — a probe must never hang
                self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

        def _statusz(self, parsed) -> None:
            fmt = parse_qs(parsed.query).get("format", ["json"])[0]
            if fmt == "text":
                from repro_torch.serve.metrics import format_stats
                self._send(200, format_stats(server.stats()).encode(),
                           "text/plain")
                return
            stats = server.stats(verbose=True)
            for name, hosted in server._programs.items():
                stats["programs"][name]["fused_segments"] = \
                    hosted.executable.report.fused_segments
            stats["log_tail"] = server.log.recent(32)
            stats["log_counts"] = server.log.counts()
            self._send_json(200, stats)

    return Handler
