"""Tiny stdlib HTTP client for fabric hops (front door -> member host);
counterpart of paddle_tpu/inference/fabric/_http.py.

urllib folds status handling, timeouts and streaming into exceptions;
``http.client`` keeps them explicit, which the router needs: a member's
4xx/5xx is a REAL ANSWER to pass through, while a transport fault
(connect refused, reset, hop timeout) is what the retry-on-another-host
rule exists for. Chunked transfer decoding is handled by
``HTTPResponse`` transparently, so the streaming relay just reads
lines.
"""
from __future__ import annotations

import http.client
import json
from typing import Dict, Optional, Tuple


class HopError(ConnectionError):
    """Transport-level hop failure (vs a member's own HTTP answer)."""


def _conn(endpoint: str, timeout: float) -> http.client.HTTPConnection:
    host, _, port = endpoint.rpartition(":")
    return http.client.HTTPConnection(host or "127.0.0.1", int(port),
                                      timeout=timeout)


def request(endpoint: str, method: str, path: str,
            body: Optional[bytes] = None,
            ctype: str = "application/json",
            timeout: float = 10.0) -> Tuple[int, Dict[str, str], bytes]:
    """One full request/response against a member endpoint. Returns
    (status, headers, body); raises HopError on transport faults."""
    conn = _conn(endpoint, timeout)
    try:
        headers = {"Content-Type": ctype} if body is not None else {}
        conn.request(method, path, body=body, headers=headers)
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, {k.lower(): v for k, v in
                             resp.getheaders()}, data
    except (OSError, http.client.HTTPException) as e:
        raise HopError(f"{method} {endpoint}{path}: {e!r}") from e
    finally:
        conn.close()


def request_json(endpoint: str, method: str, path: str,
                 obj=None, timeout: float = 10.0) -> Tuple[int, dict]:
    """JSON-in/JSON-out convenience; non-JSON bodies come back as
    {"raw": <text prefix>}."""
    body = json.dumps(obj).encode() if obj is not None else None
    status, _, data = request(endpoint, method, path, body,
                              timeout=timeout)
    try:
        return status, json.loads(data.decode() or "{}")
    except (ValueError, UnicodeDecodeError):
        return status, {"raw": data[:500].decode("utf-8", "replace")}


class StreamHop:
    """An open streaming hop: read ndjson lines as the member emits
    them. The caller owns close() (also on error paths)."""

    def __init__(self, endpoint: str, path: str, body: bytes,
                 connect_timeout: float, idle_timeout: float,
                 ctype: str = "application/json"):
        self._conn = _conn(endpoint, connect_timeout)
        try:
            self._conn.request("POST", path, body=body,
                               headers={"Content-Type": ctype})
            self.resp = self._conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            self._conn.close()
            raise HopError(f"POST {endpoint}{path}: {e!r}") from e
        # per-read timeout from here on: a stream stalls only when no
        # token arrives for idle_timeout, not when the WHOLE generation
        # outlives the connect timeout
        sock = getattr(self._conn, "sock", None)
        if sock is not None:
            sock.settimeout(idle_timeout)
        self.status = self.resp.status

    def read_body(self) -> bytes:
        try:
            return self.resp.read()
        except (OSError, http.client.HTTPException) as e:
            raise HopError(f"stream body read: {e!r}") from e

    def lines(self):
        """Yield non-empty payload lines (chunked decoding handled by
        http.client); raises HopError on transport faults mid-stream."""
        try:
            while True:
                line = self.resp.readline()
                if not line:
                    return
                line = line.strip()
                if line:
                    yield line
        except (OSError, http.client.HTTPException) as e:
            raise HopError(f"stream read: {e!r}") from e

    def close(self) -> None:
        try:
            self._conn.close()
        except Exception:  # noqa: BLE001 — best effort
            pass


__all__ = ["HopError", "request", "request_json", "StreamHop"]
