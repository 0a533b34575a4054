"""Stdlib-threaded HTTP front over the predict engine and the generation
engine (counterpart of paddle_tpu/inference/serving/server.py).

Endpoints:

  POST /predict   application/json (a ServingEngine attached):
                    {"inputs": [<input>...], "deadline_ms": optional}
                    <input> = nested list, or
                              {"b64": base64(raw C-order bytes),
                               "dtype": "float32", "shape": [2, 8]}
                    -> {"outputs": [{"b64", "dtype", "shape"}...]}
  POST /predict   application/octet-stream (raw binary):
                    per input: u64-LE nbytes + raw bytes (dtype and shape
                    from the saved spec; the batch dim, or any other
                    single dynamic axis, resolved from the byte count by
                    the pipe worker's rules, serve.decode_input)
                    -> u32-LE n_outputs, then per output:
                       u64 dtype-str len + bytes, u32 ndim,
                       i64 dims[ndim], u64 nbytes + raw bytes
  POST /generate  application/json (a GenerativeEngine attached):
                    {"input_ids": [...], "max_new_tokens": opt,
                     "eos_token_id": opt, "deadline_ms": opt,
                     "temperature", "top_k", "top_p", "seed": opt,
                     "stream": opt bool, "prefill_only": opt bool,
                     "resume_from": opt int}
                    stream=false -> the result JSON ({"tokens": [...],
                                    "n_tokens", "ttft_ms", "latency_ms",
                                    "finish_reason", ...}); prefill_only
                                    always answers so, with the handoff
                                    payload as base64
                    stream=true  -> chunked application/x-ndjson: one
                                    {"token": id} line per token as it
                                    decodes, then {"done": true, ...
                                    result}, a migrating drain's
                                    {"handoff", "streamed", "n_tokens"}
                                    or {"error", "status"}
  GET  /healthz   engine health JSON: the predict engine's, with the
                  generation engine's under "generation" when both are
                  attached (503 while either drains)
  GET  /metrics   Prometheus text format (predict and generate families)

With `admin=True` (keep the port private):

  GET  /admin/replicas  the replica rows of every front, each tagged
                        {"front": "predict"|"generate"}
  POST /admin/scale     {"front", "action": add|remove|revive, "rid"?,
                         "device"?, "drain"?, "warm"?}
                        -> the engine's report; an engine ValueError
                        (no such replica, the last active one) is 409
  POST /admin/drain     {"migrate": bool}: a graceful drain on a thread
                        of its own (healthz turns 503 at once); with
                        migrate, in-flight streams end in handoff lines
  GET  /admin/kv        {"kv": free and total slots per class,
                         "prefix": the prefix-cache residency digest}
  POST /admin/kv/import a raw handoff payload (fabric/handoff.py) -> the
                        continued stream, as /generate streams it (400
                        malformed, 409 kv_dtype or geometry, 503 queue)

A ServingError's status is the HTTP status; a 503 carries Retry-After.
Handlers only decode, enqueue and encode: the device work (a predict
batch, prefill, decode, export, import) runs on the engines' workers.
"""
from __future__ import annotations

import base64
import io
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from .lifecycle import ServingError, validate_sampling


def _decode_json_input(obj, spec):
    if isinstance(obj, dict):
        raw = base64.b64decode(obj["b64"])
        dtype = np.dtype(obj.get("dtype", spec["dtype"]))
        arr = np.frombuffer(raw, dtype=dtype)
        if "shape" in obj:
            arr = arr.reshape([int(d) for d in obj["shape"]])
        return arr
    return np.asarray(obj, dtype=np.dtype(spec["dtype"]))


class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-torch-serving/1"
    protocol_version = "HTTP/1.1"
    engine = None                 # the ServingEngine, bound below
    generator = None              # the GenerativeEngine, bound below
    admin = False                 # the /admin plane
    owner = None                  # the owning ServingHTTPServer
    # request-body byte bound: the engine's breaker caps queue depth,
    # this caps bytes before any validation runs
    max_body_bytes = 256 << 20

    def log_message(self, fmt, *args):  # quiet: metrics are the log
        pass

    # ------------------------------------------------------------ helpers --
    def _send(self, status: int, body: bytes, ctype: str,
              retry_after: Optional[float] = None):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            self.send_header("Retry-After", f"{retry_after:.3f}")
        if self.close_connection:
            # the request body was left unread (413, 404): the socket
            # closes, and HTTP/1.1 says so
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, status: int, obj,
                   retry_after: Optional[float] = None):
        self._send(status, json.dumps(obj).encode(), "application/json",
                   retry_after)

    def _send_error_obj(self, err: Exception):
        if isinstance(err, ServingError):
            self._send_json(err.status, {"error": err.message},
                            retry_after=err.retry_after)
        elif isinstance(err, TimeoutError):
            self._send_json(504, {"error": "request timed out"})
        else:
            self._send_json(500, {"error": repr(err)[:2000]})

    def _read_body(self) -> bytes:
        """The request body, refusing one over max_body_bytes with 413
        (the body stays unread, so the connection closes)."""
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            length = 0
        if length > self.max_body_bytes:
            self.close_connection = True
            raise ServingError(
                413, f"request body {length} bytes exceeds the "
                     f"{self.max_body_bytes}-byte bound")
        return self.rfile.read(length)

    # -------------------------------------------------------------- GETs --
    def do_GET(self):  # noqa: N802 — http.server API
        if self.path.startswith("/healthz"):
            if self.engine is not None:
                h = self.engine.health()
                if self.generator is not None:
                    h["generation"] = self.generator.health()
            else:
                h = self.generator.health()
            # a host of both fronts is healthy only when both are: a
            # draining generator turns the probe while predict answers
            ok = h["status"] == "ok" and \
                h.get("generation", {}).get("status", "ok") == "ok"
            self._send_json(200 if ok else 503, h)
        elif self.path.startswith("/metrics"):
            text = ""
            for eng in (self.engine, self.generator):
                if eng is not None:
                    text += eng.metrics.prometheus_text()
            self._send(200, text.encode(), "text/plain; version=0.0.4")
        elif self.path.startswith("/admin/kv") and self.admin:
            if self.generator is None:
                self._send_json(400, {"error": "no generative front"})
                return
            rep = self.generator.load_report()
            self._send_json(200, {"kv": rep["kv"],
                                  "prefix": rep["prefix"]})
        elif self.path.startswith("/admin/replicas") and self.admin:
            rows = []
            for front, eng in (("predict", self.engine),
                               ("generate", self.generator)):
                if eng is not None:
                    rows += [dict(row, front=front)
                             for row in eng.replica_states()]
            self._send_json(200, {"replicas": rows})
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    # ------------------------------------------------------------- POSTs --
    def do_POST(self):  # noqa: N802
        is_predict = self.path.startswith("/predict")
        is_generate = self.path.startswith("/generate")
        if self.admin and self.path.startswith("/admin/"):
            self._admin_post()
            return
        if not (is_predict or is_generate):
            # body not read: the connection must close, or a keep-alive
            # client's unread bytes would parse as its next request
            self.close_connection = True
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        try:
            if is_predict and self.engine is None:
                self.close_connection = True
                raise ServingError(
                    404, "no predict engine attached (generation-only "
                         "server)")
            if is_generate and self.generator is None:
                self.close_connection = True
                raise ServingError(
                    404, "no generative engine attached — construct the "
                         "server with generator=GenerativeEngine(...)")
            body = self._read_body()
            if is_generate:
                self._generate(body)
                return
            ctype = (self.headers.get("Content-Type") or
                     "application/json").split(";")[0].strip()
            if ctype == "application/octet-stream":
                self._predict_raw(body)
            else:
                self._predict_json(body)
        except Exception as e:  # noqa: BLE001 — every failure answers
            # ServingError carries its own 4xx/5xx, TimeoutError is a 504,
            # anything else a 500
            self._send_error_obj(e)

    # ------------------------------------------------------------- admin --
    def _admin_post(self):
        try:
            body = self._read_body()
            if self.path.startswith("/admin/drain"):
                try:
                    migrate = bool(json.loads(
                        body.decode() or "{}").get("migrate", False))
                except (ValueError, UnicodeDecodeError,
                        AttributeError) as e:
                    raise ServingError(
                        400, f"bad drain body: {e!r}"[:500]) from None
                self.owner.drain_async(migrate=migrate)
                self._send_json(200, {"draining": True,
                                      "migrate": migrate})
                return
            if self.path.startswith("/admin/kv/import"):
                if self.generator is None:
                    raise ServingError(400, "no generative front")
                # the raw payload in, the continued stream out, as
                # /generate streams it
                self._stream_reply(self.generator.import_handoff(body))
                return
            if not self.path.startswith("/admin/scale"):
                self.close_connection = True
                self._send_json(404, {"error": f"no route {self.path}"})
                return
            self._scale(body)
        except ValueError as e:
            # the engine's "no such replica / the last active one": 409
            self._send_json(409, {"error": str(e)[:2000]})
        except Exception as e:  # noqa: BLE001
            self._send_error_obj(e)

    def _scale(self, body: bytes):
        try:
            payload = json.loads(body.decode() or "{}")
            action = payload["action"]
        except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
            raise ServingError(400, f"bad admin body: {e!r}"[:500]) \
                from None
        front = payload.get("front", "predict")
        eng = {"predict": self.engine,
               "generate": self.generator}.get(front)
        if eng is None:
            raise ServingError(400, f"no {front!r} front on this host")
        # field coercion is request validation (400); only the engine's
        # own ValueError below is a replica-state conflict (409)
        try:
            warm = bool(payload.get("warm", True))
            drain = bool(payload.get("drain", True))
            timeout = float(payload.get("timeout", 30.0))
            rid = payload.get("rid")
            if action == "revive" or (action == "remove" and
                                      rid is not None):
                rid = int(rid)
        except (ValueError, TypeError) as e:
            raise ServingError(400, f"bad admin field: {e!r}"[:500]) \
                from None
        if action == "add":
            device = None
            if payload.get("device") is not None:
                want = str(payload["device"])
                pool = (eng._device_pool if front == "generate"
                        else [eng._device])
                matches = [d for d in pool if str(d) == want]
                if not matches:
                    raise ServingError(
                        400, f"no device {want!r} on this host")
                device = matches[0]
            report = eng.add_replica(device=device, warm=warm)
        elif action == "remove":
            report = eng.remove_replica(rid=rid, drain=drain,
                                        timeout=timeout)
        elif action == "revive":
            report = eng.revive_replica(rid)
        else:
            raise ServingError(400, f"unknown action {action!r}")
        self._send_json(200, report)

    # ---------------------------------------------------------- generate --
    def _generate(self, body: bytes):
        try:
            payload = json.loads(body.decode())
            input_ids = payload["input_ids"]
            stream = bool(payload.get("stream", False))
            kw = {"max_new_tokens": payload.get("max_new_tokens"),
                  "eos_token_id": payload.get("eos_token_id"),
                  "deadline_ms": payload.get("deadline_ms"),
                  "prefill_only": bool(payload.get("prefill_only",
                                                   False)),
                  "resume_from": payload.get("resume_from", 0)}
            # sampling fields answer 400 here, before the submit
            # enqueues: a malformed request never takes a KV slot
            kw.update(validate_sampling(payload))
        except ServingError:
            raise
        except Exception as e:  # noqa: BLE001
            raise ServingError(400, f"bad request body: {e!r}"[:2000]) \
                from None
        handle = self.generator.submit(input_ids, **kw)
        if not stream or kw["prefill_only"]:
            # prefill_only never streams: its result is the payload
            timeout = 300.0
            if kw["deadline_ms"] is not None and \
                    float(kw["deadline_ms"]) > 0:
                timeout = float(kw["deadline_ms"]) / 1e3 + 60.0
            self._send_json(200, handle.result(timeout))
            return
        self._stream_reply(handle)

    def _stream_reply(self, handle):
        """Chunked ndjson of a handle's events (/generate and
        /admin/kv/import). The 200 goes out before the first token, so a
        failure mid-generation is a terminal {"error", "status"} line."""
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(obj) -> None:
            data = (json.dumps(obj) + "\n").encode()
            self.wfile.write(f"{len(data):X}\r\n".encode() +
                             data + b"\r\n")
            self.wfile.flush()

        try:
            try:
                for kind, val in handle.events():
                    if kind == "tok":
                        chunk({"token": int(val)})
                    elif kind == "handoff":
                        # a migrating drain: not done, the stream moves
                        # hosts with this payload
                        chunk(dict(val))
                    else:
                        chunk(dict(val, done=True))
            except OSError:
                raise
            except ServingError as e:
                chunk({"error": e.message, "status": e.status})
            except Exception as e:  # noqa: BLE001
                chunk({"error": repr(e)[:2000], "status": 500})
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            # the client left mid-stream: the 200 is committed and nobody
            # is left to tell
            self.close_connection = True


    # ----------------------------------------------------------- predict --
    def _predict_json(self, body: bytes):
        try:
            payload = json.loads(body.decode())
            inputs = [_decode_json_input(o, s)
                      for o, s in zip(payload["inputs"],
                                      self.engine._specs)]
            if len(payload["inputs"]) != len(self.engine._specs):
                raise ValueError(
                    f"expected {len(self.engine._specs)} inputs")
            deadline_ms = payload.get("deadline_ms")
        except ServingError:
            raise
        except Exception as e:  # noqa: BLE001
            raise ServingError(400, f"bad request body: {e!r}"[:2000]) \
                from None
        outs = self._run(inputs, deadline_ms)
        self._send_json(200, {"outputs": [{
            "b64": base64.b64encode(
                np.ascontiguousarray(o).tobytes()).decode(),
            "dtype": str(o.dtype),
            "shape": [int(d) for d in o.shape],
        } for o in outs]})

    def _predict_raw(self, body: bytes):
        # the pipe worker's byte-count rules (at most one dynamic axis an
        # input resolves from a size; JSON carries explicit shapes)
        from ..serve import decode_input

        buf = io.BytesIO(body)
        inputs = []
        for i, spec in enumerate(self.engine._specs):
            hdr = buf.read(8)
            if len(hdr) < 8:
                raise ServingError(400, "truncated raw body")
            (nbytes,) = struct.unpack("<Q", hdr)
            raw = buf.read(nbytes)
            if len(raw) < nbytes:
                raise ServingError(400, "truncated raw body")
            try:
                inputs.append(decode_input(raw, spec, i))
            except ValueError as e:
                raise ServingError(400, str(e)) from None
        outs = self._run(inputs, None)
        reply = io.BytesIO()
        reply.write(struct.pack("<I", len(outs)))
        for o in outs:
            o = np.ascontiguousarray(o)
            dt = str(o.dtype).encode()
            reply.write(struct.pack("<Q", len(dt)) + dt)
            reply.write(struct.pack("<I", o.ndim))
            reply.write(struct.pack(f"<{o.ndim}q", *o.shape))
            b = o.tobytes()
            reply.write(struct.pack("<Q", len(b)) + b)
        self._send(200, reply.getvalue(), "application/octet-stream")

    def _run(self, inputs, deadline_ms):
        timeout = 120.0
        if deadline_ms is not None and float(deadline_ms) > 0:
            timeout = float(deadline_ms) / 1e3 + 5.0
        return self.engine.predict(inputs, deadline_ms=deadline_ms,
                                   timeout=timeout)


class _Listener(ThreadingHTTPServer):
    # socketserver's listen backlog is 5: a burst of connections past it
    # loses SYNs, and each client's retransmit waits out the kernel's
    # timeout (a 16-connection burst read 0.4-0.6 s of client TTFT
    # against the engine's 0.04-0.14 s on the CPU; 0.02-0.04 s with 64)
    request_queue_size = 128
    daemon_threads = True


class ServingHTTPServer:
    """ThreadingHTTPServer over a predict engine (`engine`, a
    ServingEngine), a generation engine (`generator`, a
    GenerativeEngine) or both: start()/stop() for embedding,
    serve_forever() for the CLI."""

    def __init__(self, engine=None, host: str = "127.0.0.1", port: int = 0,
                 max_body_bytes: Optional[int] = None, generator=None,
                 admin: bool = False):
        if engine is None and generator is None:
            raise ValueError("need an engine, a generator, or both")
        attrs = {"engine": engine, "generator": generator,
                 "admin": bool(admin), "owner": self}
        if max_body_bytes is not None:
            attrs["max_body_bytes"] = int(max_body_bytes)
        handler = type("BoundHandler", (_Handler,), attrs)
        self.engine = engine
        self.generator = generator
        self.admin = bool(admin)
        self._drainer: Optional[threading.Thread] = None
        self.httpd = _Listener((host, port), handler)
        self.host, self.port = self.httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="serving-http", daemon=True)
        self._thread.start()
        return self

    def load_report(self) -> dict:
        """The load digest a fabric heartbeat would publish: queue depth
        and replicas summed over the fronts, each front's own report
        under "fronts", and the generate front's "kv" and "prefix"
        digests hoisted to the top level (a predict-only host has
        none)."""
        rep = {"queue_depth": 0, "replicas": 0, "fronts": {}}
        if self.engine is not None:
            rep["fronts"]["predict"] = self.engine.load_report()
        if self.generator is not None:
            rep["fronts"]["generate"] = self.generator.load_report()
        for fr in rep["fronts"].values():
            rep["queue_depth"] += int(fr.get("queue_depth", 0))
            rep["replicas"] += int(fr.get("replicas", 0))
        gen = rep["fronts"].get("generate")
        if gen is not None:
            for k in ("kv", "prefix"):
                if k in gen:
                    rep[k] = gen[k]
        return rep

    def drain_async(self, migrate: bool = False) -> None:
        """A graceful drain of every front on a thread of its own (POST
        /admin/drain): /healthz turns 503 at once; the listener stays up
        so in-flight replies finish. migrate=True ends the generate
        front's in-flight streams in handoff lines instead of finishing
        them."""
        if self._drainer is not None:
            return
        t = threading.Thread(target=lambda: self._shutdown_engines(
            True, migrate), name="serving-drain", daemon=True)
        self._drainer = t
        t.start()

    def _shutdown_engines(self, drain: bool, migrate: bool) -> None:
        if self.engine is not None:
            self.engine.shutdown(drain=drain)
        if self.generator is not None:
            self.generator.shutdown(drain=drain, migrate=migrate)

    def serve_forever(self):
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self, drain: bool = True, migrate: bool = False):
        """Graceful stop: the engines drain first (in-flight replies get
        their results, or with migrate=True the generate front's their
        handoff lines), then the listener closes."""
        self._shutdown_engines(drain, migrate)
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(10.0)
            self._thread = None


__all__ = ["ServingHTTPServer"]
