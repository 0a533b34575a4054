"""The fleet's HTTP front door: one address, N serving hosts
(counterpart of paddle_tpu/inference/fabric/frontdoor.py).

Extends the serving tier's stdlib HTTP front (serving/server._Handler
— same helpers, same error taxonomy) with the router behind it instead
of a local engine:

  POST /predict    forwarded verbatim (JSON or raw-binary — the body
                   is opaque to the router) to a least-loaded member
  POST /generate   stream=false forwarded like /predict;
                   stream=true relayed token-by-token (chunked ndjson)
                   from the affinity member, with the streamed==0
                   retry rule (router.stream_generate)
  GET  /healthz    fleet aggregate: 200 while >=1 member is alive,
                   503 on an empty/evicted fleet; body carries the
                   member table
  GET  /fleet      the member table + router counters as JSON (the
                   chaos tests' and operators' view)
  GET  /metrics    paddle_fabric_* + every member's own exposition
                   merged under a host= label (scraped per request
                   with a short per-host budget; a member that times
                   out contributes its last good scrape)

The reference's door also fronts its sparse-embedding tier
(``/embed/lookup``, ``/embed/push``); the port has no embedding tier
yet (ROADMAP queue 6), so those routes answer 404.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, Optional

from ...observability import trace as _tr
from ..serving.lifecycle import ServingError, validate_sampling
from ..serving.server import _Handler, _Listener
from . import _http
from .metrics import merge_expositions
from .router import FabricRouter


class _FrontDoorHandler(_Handler):
    server_version = "paddle-tpu-torch-fabric/1"
    router: FabricRouter = None     # bound by FabricHTTPServer
    frontdoor = None                # the owning FabricHTTPServer

    # -------------------------------------------------------------- GETs --
    def do_GET(self):  # noqa: N802 — http.server API
        if self.path.startswith("/healthz"):
            rows = self.router.view.rows()
            alive = sum(1 for r in rows if r["state"] == "alive")
            body = {
                "status": "ok" if alive else "no_hosts",
                "hosts_alive": alive,
                "hosts": rows,
            }
            self._send_json(200 if alive else 503, body)
        elif self.path.startswith("/metrics"):
            text = self.router.metrics.prometheus_text()
            text += self.frontdoor.scrape_members()
            self._send(200, text.encode(), "text/plain; version=0.0.4")
        elif self.path.startswith("/fleet"):
            body = {
                "hosts": self.router.view.rows(),
                "counters": self.router.view.counters_snapshot(),
                "router": self.router.metrics.snapshot(),
            }
            self._send_json(200, body)
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    # ------------------------------------------------------------- POSTs --
    def do_POST(self):  # noqa: N802
        is_predict = self.path.startswith("/predict")
        is_generate = self.path.startswith("/generate")
        if not (is_predict or is_generate):
            self.close_connection = True
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > self.max_body_bytes:
                self.close_connection = True
                raise ServingError(
                    413, f"request body {length} bytes exceeds the "
                         f"{self.max_body_bytes}-byte bound")
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or
                     "application/json").split(";")[0].strip()
            with _tr.span("fabric.route", "fabric",
                          {"path": self.path}) as sp:
                if is_predict:
                    self._relay_plain("/predict", body, ctype,
                                      pool="predict", parent=sp.ctx)
                else:
                    self._generate(body, sp.ctx)
        except Exception as e:  # noqa: BLE001 — ServingError carries
            # its own status; the rest map like the serving front
            self._send_error_obj(e)

    def _relay_plain(self, path: str, body: bytes, ctype: str,
                     pool: Optional[str], parent,
                     gen_req: Optional[dict] = None) -> None:
        status, headers, data = self.router.forward(
            path, body, ctype, pool=pool, parent_ctx=parent,
            gen_req=gen_req)
        retry_after = None
        if "retry-after" in headers:
            try:
                retry_after = float(headers["retry-after"])
            except ValueError:
                retry_after = None
        self._send(status, data,
                   headers.get("content-type", "application/json"),
                   retry_after)

    def _generate(self, body: bytes, parent) -> None:
        try:
            payload = json.loads(body.decode())
            if not isinstance(payload, dict):
                raise ServingError(
                    400, f"request body must be a JSON object, got "
                         f"{type(payload).__name__}")
            stream = bool(payload.get("stream", False))
            affinity = payload.get("session")
            if affinity is None:
                affinity = json.dumps(payload.get("input_ids"))
            affinity_key = str(affinity).encode()
            # the router's KV-aware pick + residency affinity read the
            # prompt and expected decode length, not the opaque body
            gen_req = {"input_ids": payload.get("input_ids"),
                       "max_new_tokens": payload.get("max_new_tokens")}
        except (ValueError, UnicodeDecodeError, TypeError) as e:
            raise ServingError(400, f"bad request body: {e!r}"[:2000]) \
                from None
        # sampling validation at the door: a malformed request 400s
        # here instead of burning a member hop + KV slot downstream
        validate_sampling(payload)
        if not stream:
            self._relay_plain("/generate", body, "application/json",
                              pool="generate", parent=parent,
                              gen_req=gen_req)
            return
        # streamed: commit the 200 only after the upstream hop is
        # answering — router.stream_generate raises (-> a real HTTP
        # error status) when nothing has been emitted yet, so the
        # pre-stream failure path still gets a clean 503/4xx
        committed = False

        def emit(line: bytes) -> None:
            nonlocal committed
            if not committed:
                committed = True
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
            data = line + b"\n"
            self.wfile.write(f"{len(data):X}\r\n".encode() + data +
                             b"\r\n")
            self.wfile.flush()

        try:
            self.router.stream_generate(body, affinity_key, emit,
                                        parent_ctx=parent,
                                        gen_req=gen_req)
            if committed:
                self.wfile.write(b"0\r\n\r\n")
            else:
                # member closed with an empty 200 stream (no lines):
                # surface an explicit empty ndjson body
                self._send(200, b"", "application/x-ndjson")
        except ServingError:
            if committed:
                self.close_connection = True
                return
            raise
        except OSError:
            # the CLIENT went away mid-relay: nothing left to tell
            self.close_connection = True


class FabricHTTPServer:
    """ThreadingHTTPServer bound to one FabricRouter; the fleet's
    single public address. start()/stop() for embedding,
    serve_forever() for a CLI."""

    def __init__(self, router: FabricRouter, host: str = "127.0.0.1",
                 port: int = 0, max_body_bytes: Optional[int] = None,
                 member_scrape_timeout_s: float = 1.0):
        attrs = {"router": router, "frontdoor": self}
        if max_body_bytes is not None:
            attrs["max_body_bytes"] = int(max_body_bytes)
        handler = type("BoundFrontDoor", (_FrontDoorHandler,), attrs)
        self.router = router
        self.member_scrape_timeout_s = float(member_scrape_timeout_s)
        self._scrape_cache: Dict[str, str] = {}
        self._scrape_lock = threading.Lock()
        self.httpd = _Listener((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ metrics --
    def scrape_members(self) -> str:
        """Merged member expositions (host-labeled). Per-host budget is
        short; a slow/dead member contributes its last good scrape so
        one sick host cannot stall the fleet's whole /metrics."""
        parts: Dict[str, str] = {}
        for m in self.router.view.alive():
            try:
                status, _, data = _http.request(
                    m.endpoint, "GET", "/metrics",
                    timeout=self.member_scrape_timeout_s)
                if status == 200:
                    text = data.decode("utf-8", "replace")
                    with self._scrape_lock:
                        self._scrape_cache[m.host_id] = text
                    parts[m.host_id] = text
                    continue
            except (_http.HopError, OSError):
                pass
            with self._scrape_lock:
                cached = self._scrape_cache.get(m.host_id)
            if cached:
                parts[m.host_id] = cached
        return merge_expositions(parts)

    # ---------------------------------------------------------- lifecycle --
    def start(self) -> "FabricHTTPServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="fabric-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(10.0)
            self._thread = None
        self.router.view.close()


__all__ = ["FabricHTTPServer"]
