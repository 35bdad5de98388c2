"""Live introspection server: an opt-in localhost HTTP view of a serve
(PyTorch port of ``raft_stereo_tpu/runtime/debug_server.py``).

``--debug_port`` starts one stdlib HTTP server on a daemon thread
(``debug-server``) bound to 127.0.0.1; port 0 binds an ephemeral port
(``DebugServer.port`` reports it). Endpoints, all read-only JSON but
``/metrics``:

  ``/healthz``                 serving / draining / frozen, open circuits,
                               the provider census
  ``/metrics``                 the telemetry registry's Prometheus text
  ``/debug/queues``            scheduler, tier and cascade snapshots
  ``/debug/snapshots``         every registered provider's snapshot
  ``/debug/stacks``            every thread's stack, with its role
  ``/debug/quality``           the quality observatory's snapshot (404
                               without a monitor)
  ``/debug/requests/<trace>``  the flight-recorder events of that trace id

Every handler reads through the same lock-disciplined ``snapshot()`` hooks
the blackbox dumper uses, so a probe cannot mutate or deadlock the serve.
The server touches no CUDA state.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Any, Dict, Optional, Tuple

from raft_stereo_tpu_torch.runtime import blackbox, quality, telemetry

logger = logging.getLogger(__name__)

# provider kinds whose snapshots describe queues and routing
_QUEUE_KINDS = ("scheduler", "tiered", "cascade")


class _Handler(BaseHTTPRequestHandler):
    server_version = "raft-stereo-debug/1.0"
    # one request per connection: the single server thread must never park
    # in a keep-alive client's readline
    protocol_version = "HTTP/1.0"

    def log_message(self, fmt, *args):
        logger.debug("debug-server: " + fmt, *args)

    def do_GET(self):  # noqa: N802 — the stdlib handler's name
        try:
            body, status, ctype = self.server.ctx.render(self.path)
        except Exception as e:  # noqa: BLE001 — a probe must never crash
            body = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
            status, ctype = 500, "application/json"
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class DebugServer:
    """One serve's introspection endpoint."""

    def __init__(self, port: int, *, host: str = "127.0.0.1",
                 dumper: Optional[blackbox.BlackboxDumper] = None):
        self._dumper = dumper
        self._t0 = time.monotonic()
        self._srv = HTTPServer((host, int(port)), _Handler)
        self._srv.ctx = self
        self.host = self._srv.server_address[0]
        self.port = int(self._srv.server_address[1])
        self._thread = threading.Thread(target=self._srv.serve_forever, name="debug-server",
                                        daemon=True)

    def start(self) -> "DebugServer":
        self._thread.start()
        logger.info("debug server listening on http://%s:%d (/healthz /metrics /debug/queues "
                    "/debug/stacks /debug/quality /debug/requests/<trace_id>)", self.host,
                    self.port)
        return self

    def close(self) -> None:
        """Stop serving and join the thread (idempotent)."""
        if self._thread.is_alive():
            self._srv.shutdown()
            self._thread.join(timeout=10.0)
        self._srv.server_close()

    # ------------------------------------------------------------- views

    def _snapshots(self, kinds: Optional[Tuple[str, ...]] = None) -> Dict[str, Any]:
        """Provider snapshots (each isolated), optionally by kind."""
        dumper = self._dumper or blackbox.get()
        out: Dict[str, Any] = {}
        if dumper is None:
            return out
        for name, fn in sorted(dumper.providers().items()):
            # provider names are "<kind>[:<tier>][#<n>]"
            kind = name.split("#", 1)[0].split(":", 1)[0]
            if kinds is not None and kind not in kinds:
                continue
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — isolated per provider
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def _healthz(self) -> Dict[str, Any]:
        snaps = self._snapshots()
        dicts = [s for s in snaps.values() if isinstance(s, dict)]
        draining = any(s.get("draining") for s in dicts)
        frozen = any(s.get("frozen") for s in dicts)
        circuits = sum(len(s.get("broken_buckets") or {}) for s in dicts)
        return {
            "ok": True,
            "status": "frozen" if frozen else ("draining" if draining else "serving"),
            "draining": draining,
            "frozen": frozen,
            "circuits_open": circuits,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "providers": sorted(snaps),
            "telemetry": telemetry.get() is not None,
        }

    def _requests(self, trace_id: str) -> Optional[Dict[str, Any]]:
        tel = telemetry.get()
        if tel is None:
            return None
        events = [e for e in tel.ring_snapshot()["events"]
                  if e.get("trace_id") == trace_id or trace_id in (e.get("trace_ids") or ())]
        return {"trace_id": trace_id, "events": events} if events else None

    def render(self, path: str) -> Tuple[bytes, int, str]:
        """``(body, status, content_type)`` for one GET path."""
        path = path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            tel = telemetry.get()
            if tel is None:
                return b"# no telemetry sink installed\n", 404, "text/plain; version=0.0.4"
            text = tel.metrics.to_prometheus()
            if tel.slo is not None:
                text += tel.slo.to_prometheus()
            return text.encode(), 200, "text/plain; version=0.0.4"
        if path == "/healthz":
            doc: Any = self._healthz()
        elif path == "/debug/queues":
            doc = self._snapshots(_QUEUE_KINDS)
        elif path == "/debug/snapshots":
            doc = self._snapshots()
        elif path == "/debug/stacks":
            doc = {"threads": blackbox.thread_stacks()}
        elif path == "/debug/quality":
            mon = quality.get()
            if mon is None:
                return (json.dumps({"error": "no quality monitor installed (--no_quality, or "
                                             "a serve without the observatory)"}).encode(),
                        404, "application/json")
            doc = mon.snapshot()
        elif path.startswith("/debug/requests/"):
            doc = self._requests(path[len("/debug/requests/"):])
            if doc is None:
                return (json.dumps({"error": "unknown trace_id (not in the flight "
                                             "recorder)"}).encode(), 404, "application/json")
        else:
            return (json.dumps({"error": f"unknown path {path!r}"}).encode(), 404,
                    "application/json")
        return json.dumps(doc, indent=1, default=str).encode(), 200, "application/json"


__all__ = ["DebugServer"]
