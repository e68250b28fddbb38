"""Live metrics endpoint: a stdlib `ThreadingHTTPServer` that exposes a
serving target's MetricsRegistry (and optional SLOMonitor) over HTTP.

The target is duck-typed so the same exporter attaches to a
`RetrievalEngine`, a `ShardRouter`, or any test double:

  * `target.metrics`           — a MetricsRegistry (required)
  * `target.stats()`           — called before each export to let the
                                 target sync derived gauges (optional;
                                 exceptions are swallowed so a scrape
                                 can never take down serving)
  * `target.missing_shards()`  — shards with zero live replicas
                                 (optional; router only) — feeds /healthz

Routes:

  GET /metrics       Prometheus text exposition (registry.to_prometheus())
  GET /metrics.json  registry.snapshot() as JSON
  GET /slo           SLOMonitor.evaluate() + status (or {"state":
                     "disabled"} when no monitor is attached)
  GET /healthz       200 {"ok": true} — or 503 with a "reasons" list when
                     the SLO state is PAGE or any shard has lost every
                     replica

The server runs daemon-threaded on `host:port` (port 0 binds an
ephemeral port, exposed as `exporter.port`), one thread per request, and
never writes access logs. Scrapes are read-only against the registry's
own locks, so concurrent scrapes during live serving are safe.

A copy of the JAX package's `repro.obs.exporter` (stdlib only).
"""

import http.server
import json
import socketserver
import threading


class _Handler(http.server.BaseHTTPRequestHandler):
    # BaseHTTPRequestHandler logs every request to stderr by default;
    # a scraper polling /metrics at 1 Hz would drown serving output.
    def log_message(self, fmt, *args):
        pass

    def _send(self, code, body, content_type="application/json"):
        data = body.encode() if isinstance(body, str) else body
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        exp = self.server.exporter
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                self._send(200, exp.render_prometheus(),
                           content_type="text/plain; version=0.0.4")
            elif path == "/metrics.json":
                self._send(200, json.dumps(exp.render_snapshot()))
            elif path == "/slo":
                self._send(200, json.dumps(exp.render_slo()))
            elif path == "/healthz":
                ok, reasons = exp.health()
                self._send(200 if ok else 503,
                           json.dumps({"ok": ok, "reasons": reasons}))
            else:
                self._send(404, json.dumps({"error": f"no route {path}"}))
        except Exception as e:  # a scrape must never crash the server
            try:
                self._send(500, json.dumps({"error": repr(e)}))
            except Exception:
                pass


class _Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
    daemon_threads = True
    allow_reuse_address = True


class MetricsExporter:
    """Attach an HTTP metrics/health surface to a serving target.

    Usage:
        with MetricsExporter(engine, port=0, slo=monitor) as exp:
            url = f"http://127.0.0.1:{exp.port}/metrics"
    """

    def __init__(self, target, *, port=0, host="127.0.0.1", slo=None):
        self.target = target
        self.slo = slo
        self._server = _Server((host, port), _Handler)
        self._server.exporter = self
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = None

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._server.serve_forever, name="metrics-exporter",
                daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- rendering ---------------------------------------------------------

    def _sync(self):
        """Let the target fold derived/per-host gauges into its registry
        before export. Best-effort: serving state may be mid-transition
        (e.g. a reload), and a scrape must never raise into serving."""
        stats = getattr(self.target, "stats", None)
        if callable(stats):
            try:
                stats()
            except Exception:
                pass

    def render_prometheus(self):
        self._sync()
        return self.target.metrics.to_prometheus()

    def render_snapshot(self):
        self._sync()
        return self.target.metrics.snapshot()

    def render_slo(self):
        if self.slo is None:
            return {"state": "disabled"}
        self.slo.evaluate()
        return self.slo.status()

    def health(self):
        """(ok, reasons). Unhealthy when the SLO pages or a shard has no
        live replica left; otherwise healthy."""
        reasons = []
        if self.slo is not None:
            self.slo.evaluate()
            if self.slo.state == "PAGE":
                reasons.append("slo_page")
        missing = getattr(self.target, "missing_shards", None)
        if callable(missing):
            try:
                lost = list(missing())
            except Exception as e:
                lost = []
                reasons.append(f"missing_shards_error:{e!r}")
            if lost:
                reasons.append(f"shards_without_replicas:{sorted(lost)}")
        return (not reasons), reasons
