"""Live scrape endpoint -- the obs registry as Prometheus text format;
a copy of ``dtf_tpu/obs/prom.py`` (the port imports nothing of
dtf_tpu).

Long runs want a LIVE window beside the post-run metric.log: curl the
serving process or rank 0 mid-run and see queue depth, prefix hits,
the MFU ledger's gauges, step time.  The standard library only --
`http.server` on a daemon thread, one handler, text-format v0.0.4 --
not a prometheus_client dependency.

Mapping (names pass through; the repo already uses snake_case with
embedded units, e.g. ``data_reader_lag_s``):

  Counter    -> `# TYPE <name> counter` + one sample
  Gauge      -> `# TYPE <name> gauge` + one sample
  Histogram  -> `# TYPE <name> summary`: quantile series from the
                registry's reservoir percentiles, plus <name>_sum /
                <name>_count

Scrape surface: ``GET /metrics`` (and ``/`` as an alias) plus
``GET /healthz`` — a JSON liveness probe for external health checkers
(k8s-style): 200 ``{"ok": true, ...}`` while healthy, 503 when the
optional ``health_fn`` reports ``ok: false`` (a draining serving
process: ``cli/serve_main.py`` feeds it the engine's ``draining``).
The registry is re-snapshotted per request — the server holds a
callable, not a frozen snapshot, so `MetricsRegistry.reset()` between
runs in one process is reflected immediately; ``health_fn`` is likewise
re-evaluated per probe.
"""

from __future__ import annotations

import json
import logging
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from dtf_tpu_torch.obs.registry import (Histogram, MetricsRegistry,
                                  default_registry)

log = logging.getLogger("dtf_tpu_torch")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _sample(value: float) -> str:
    """Prometheus sample value formatting (+Inf/-Inf/NaN spellings)."""
    v = float(value)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def prometheus_text(registry: MetricsRegistry) -> str:
    """The registry as a Prometheus text-format exposition string."""
    lines = []
    snap = registry.snapshot()
    for name in sorted(snap):
        s = snap[name]
        kind = s["type"]
        if kind == "histogram":
            lines.append(f"# TYPE {name} summary")
            for q in Histogram.PERCENTILES:
                lines.append(
                    f'{name}{{quantile="{q / 100:g}"}} '
                    f'{_sample(s[f"p{q:g}"])}')
            lines.append(
                f"{name}_sum {_sample(s['mean'] * s['count'])}")
            lines.append(f"{name}_count {s['count']}")
        else:
            lines.append(f"# TYPE {name} {kind}")
            lines.append(f"{name} {_sample(s['value'])}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """`GET /metrics` over stdlib ThreadingHTTPServer, daemon threads.

    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``.port``.  ``registry_fn`` defaults to the process-global default
    registry, resolved per request.  ``health_fn`` (optional) returns a
    dict merged into the ``/healthz`` JSON; ``{"ok": False, ...}``
    turns the probe into a 503 so external checkers (and the chaos
    matrix) can distinguish alive-but-degraded from healthy."""

    def __init__(self, port: int,
                 registry_fn: Optional[Callable[[], MetricsRegistry]]
                 = None, host: str = "",
                 health_fn: Optional[Callable[[], dict]] = None):
        registry_fn = registry_fn or default_registry

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server contract
                path = self.path.split("?")[0]
                if path == "/healthz":
                    payload = {"ok": True}
                    if health_fn is not None:
                        try:
                            payload.update(health_fn() or {})
                        except Exception as e:  # noqa: BLE001 — a probe
                            # must answer, not 500 into a flapping check
                            payload = {"ok": False, "error": str(e)}
                    body = (json.dumps(payload) + "\n").encode()
                    self.send_response(200 if payload.get("ok", True)
                                       else 503)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if path not in ("/", "/metrics"):
                    self.send_error(404)
                    return
                body = prometheus_text(registry_fn()).encode()
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # scrapes are not news
                log.debug("metrics server: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.5},
            daemon=True, name="dtf-metrics-server")
        self._thread.start()
        log.info("metrics server: serving Prometheus text on port %d "
                 "(GET /metrics)", self.port)

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
