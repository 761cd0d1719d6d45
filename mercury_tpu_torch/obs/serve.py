"""Live scrape plane: ``/healthz``, ``/statusz`` and ``/metricsz`` — the
port's own copy of ``mercury_tpu/obs/serve.py`` (standard library only).

A small HTTP endpoint that ``curl`` or a Prometheus-compatible scraper can
read while a run is live:

- ``/healthz``: liveness and the supervisor's ladder level. 200 while the
  run is healthy (the ladder at ``async``), 503 once degraded, so a plain
  HTTP prober is also an SLO pager.
- ``/statusz``: one JSON document of what an operator asks first: the run
  manifest, the supervisor's state, the scorer's tenant queues and the
  tail of the event journal.
- ``/metricsz``: the latest metric record in OpenMetrics text (gauges and
  the mandatory ``# EOF``), from the
  :class:`~mercury_tpu_torch.obs.writer.AsyncMetricWriter`'s latest host
  record. A scrape costs one dict copy and never reads the card.

Everything is pull-based and read-only: the server holds callbacks (each
returning a plain dict) and calls them per request on the serving thread,
so a scraper never blocks the training thread. Off by default: the
Trainer starts one on rank 0 only when ``serve_port`` > 0; without it
there is no thread and no socket.

Threads: one daemon accept thread ``mercury-serve`` running a
``ThreadingHTTPServer`` (a daemon thread a request). ``close()`` shuts the
socket and joins the accept thread.
"""

from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

from mercury_tpu_torch.utils.logging import get_logger

_log = get_logger(__name__)

__all__ = ["StatusServer", "render_openmetrics", "parse_openmetrics",
           "OPENMETRICS_CONTENT_TYPE", "metric_name"]

#: The content type negotiated by OpenMetrics-aware scrapers.
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_]")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>\S+)(?:\s+\S+)?$")


def metric_name(key: str, prefix: str = "mercury") -> str:
    """``train/loss`` -> ``mercury_train_loss``: map a Mercury metric
    key onto the OpenMetrics name charset ``[a-zA-Z0-9_]``."""
    name = _NAME_BAD.sub("_", key.strip())
    if prefix:
        name = f"{prefix}_{name}"
    return name.strip("_")


def render_openmetrics(record: Optional[Dict[str, float]],
                       prefix: str = "mercury") -> str:
    """Render one metric record as OpenMetrics text exposition.

    Every Mercury metric is a point-in-time host float, so everything
    exports as a ``gauge``. The output always terminates with the
    mandatory ``# EOF`` marker — an empty record renders to just that,
    which is still a valid (empty) exposition."""
    lines: List[str] = []
    for key in sorted(record or {}):
        value = (record or {})[key]
        try:
            value = float(value)
        except (TypeError, ValueError):
            continue
        name = metric_name(key, prefix=prefix)
        lines.append(f"# TYPE {name} gauge")
        lines.append(f'# HELP {name} Mercury metric key "{key}".')
        lines.append(f"{name} {value!r}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def parse_openmetrics(text: str) -> Dict[str, float]:
    """Minimal OpenMetrics text parser: name -> value for every sample
    line. Raises ``ValueError`` on a malformed sample line or a missing
    ``# EOF`` terminator — strict enough that the round-trip test
    actually vouches for the exposition format."""
    samples: Dict[str, float] = {}
    saw_eof = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if saw_eof:
            raise ValueError(f"content after # EOF: {line!r}")
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in (
                    "TYPE", "HELP", "UNIT"):
                raise ValueError(f"malformed metadata line: {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed sample line: {line!r}")
        samples[m.group("name")] = float(m.group("value"))
    if not saw_eof:
        raise ValueError("missing # EOF terminator")
    return samples


class _Handler(BaseHTTPRequestHandler):
    """Routes the three endpoints; everything else is 404."""

    server_version = "mercury-serve/1"
    protocol_version = "HTTP/1.1"

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        srv: "StatusServer" = self.server.status_server  # type: ignore
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/healthz":
                status, body = srv.healthz()
                self._reply(status, json.dumps(body, default=str) + "\n",
                            "application/json")
            elif path == "/statusz":
                self._reply(200,
                            json.dumps(srv.statusz(), default=str,
                                       indent=2) + "\n",
                            "application/json")
            elif path == "/metricsz":
                self._reply(200, srv.metricsz(), OPENMETRICS_CONTENT_TYPE)
            else:
                self._reply(404, json.dumps(
                    {"error": "not found",
                     "endpoints": ["/healthz", "/statusz",
                                   "/metricsz"]}) + "\n",
                    "application/json")
        except Exception as exc:  # never let a callback kill the thread
            self._reply(500, json.dumps(
                {"error": f"{type(exc).__name__}: {exc}"}) + "\n",
                "application/json")

    def _reply(self, status: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt: str, *args) -> None:
        _log.debug("scrape %s", fmt % args)


class StatusServer:
    """The live scrape endpoint. All state arrives via callbacks:

    - ``health_fn`` -> supervisor-ish dict; ``{"level": 0, ...}``. 503
      when ``level`` > 0 or ``healthy`` is explicitly False.
    - ``status_fn`` -> the ``/statusz`` document (manifest, ladder,
      tenant queues, last N journal events) — composed by the trainer.
    - ``metrics_fn`` -> the latest host metric record (or None).

    ``port=0`` binds an ephemeral port (tests); the bound port is
    ``self.port`` after construction. The accept thread starts in the
    constructor and is a daemon, so a hung scrape can never block
    interpreter exit; ``close()`` is idempotent."""

    def __init__(
        self,
        port: int,
        *,
        host: str = "127.0.0.1",
        health_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        status_fn: Optional[Callable[[], Dict[str, Any]]] = None,
        metrics_fn: Optional[Callable[[], Optional[Dict[str, float]]]]
        = None,
    ) -> None:
        self._health_fn = health_fn
        self._status_fn = status_fn
        self._metrics_fn = metrics_fn
        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.status_server = self  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._closed = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="mercury-serve",
            daemon=True)
        self._thread.start()
        _log.info("status server listening on http://%s:%d "
                  "(/healthz /statusz /metricsz)", self.host, self.port)

    # ------------------------------------------------------------ endpoints
    def healthz(self) -> Tuple[int, Dict[str, Any]]:
        """(http_status, body): 200 healthy / 503 degraded-or-broken."""
        body: Dict[str, Any] = {"alive": True}
        try:
            body.update(self._health_fn() if self._health_fn else {})
        except Exception as exc:
            return 503, {"alive": True, "healthy": False,
                         "error": f"{type(exc).__name__}: {exc}"}
        degraded = int(body.get("level", 0) or 0) > 0
        healthy = bool(body.get("healthy", not degraded)) and not degraded
        body["healthy"] = healthy
        return (200 if healthy else 503), body

    def statusz(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {"endpoint": "/statusz"}
        if self._status_fn is not None:
            doc.update(self._status_fn())
        return doc

    def metricsz(self) -> str:
        record = self._metrics_fn() if self._metrics_fn else None
        return render_openmetrics(record)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Stop accepting, close the socket, join the accept thread."""
        if self._closed:
            return
        self._closed = True
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        finally:
            self._thread.join(timeout=5.0)

    def __enter__(self) -> "StatusServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
