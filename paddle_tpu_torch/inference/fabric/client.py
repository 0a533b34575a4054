"""Client-side failover over N front doors (counterpart of
paddle_tpu/inference/fabric/client.py).

With the quorum store the registry survives its host, so the last
single point is the door itself. Any number of :class:`~.frontdoor.FabricHTTPServer` processes
can serve the same fleet — they share the registry, the membership
ladder is deterministic per observer, and the consistent-hash ring is
a pure function of the alive set, so EVERY door routes a given session
to the same member. What remains is the client half: spread requests
over the doors and fail over when one dies. :class:`FleetClient` is
that contract, and the reference implementation the chaos tests and
smoke drive:

- non-streamed requests rotate over the doors (client-side load
  spreading needs no coordination) and a TRANSPORT fault retries on
  the next door — each door at most once per request. A door's HTTP
  answer (2xx/4xx/5xx) is an answer and is returned as-is: the door
  already ran its own one-retry-on-another-member rule, so stacking
  another member retry here would multiply attempts.
- a streamed ``/generate`` that dies BEFORE the first token retries on
  the next door (nothing reached the caller — re-execution is safe).
  After any token it RESUMES on the next door: generation is
  deterministic (the key-chain law), so the request replays with
  ``resume_from=<tokens already delivered>`` and the new door's member
  emits only the unseen suffix — never a duplicate token. Only when
  every door is gone does the caller get its strict prefix plus one
  terminal ``{"error": ..., "status": 503}`` line — the same contract
  the door itself emits when NO member can resume a stream, so a
  consumer handles door exhaustion and fleet exhaustion identically.
"""
from __future__ import annotations

import json
import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ..serving.lifecycle import ServingError, validate_sampling
from . import _http


def _as_endpoint(door: str) -> str:
    """Accept 'host:port' or 'http://host:port[/]'."""
    door = str(door).strip()
    if door.startswith("http://"):
        door = door[len("http://"):]
    return door.rstrip("/")


class FleetClient:
    """One client, N interchangeable front doors."""

    def __init__(self, doors, timeout_s: float = 30.0,
                 stream_idle_timeout_s: float = 60.0):
        if isinstance(doors, str):
            doors = [d for d in doors.split(",") if d.strip()]
        self.doors: List[str] = [_as_endpoint(d) for d in doors]
        if not self.doors:
            raise ValueError("FleetClient needs at least one front door")
        self.timeout_s = float(timeout_s)
        self.stream_idle_timeout_s = float(stream_idle_timeout_s)
        self._lock = threading.Lock()
        self._rr = 0
        self.counters = {"door_retries": 0, "streams_broken": 0,
                         "streams_resumed": 0}

    # ------------------------------------------------------------ rotation --
    def _order(self) -> List[str]:
        with self._lock:
            start = self._rr
            self._rr = (self._rr + 1) % len(self.doors)
        return self.doors[start:] + self.doors[:start]

    def counters_snapshot(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def _bump(self, key: str) -> None:
        with self._lock:
            self.counters[key] += 1

    # --------------------------------------------------------- non-streamed --
    def request(self, path: str, obj: Optional[dict] = None,
                method: str = "POST") -> Tuple[int, dict]:
        """(status, body) from the first door that ANSWERS; transport
        faults rotate to the next door. Raises HopError only when every
        door is unreachable."""
        last: Optional[Exception] = None
        for i, door in enumerate(self._order()):
            if i:
                self._bump("door_retries")
            try:
                return _http.request_json(door, method, path, obj,
                                          timeout=self.timeout_s)
            except _http.HopError as e:
                last = e
        raise _http.HopError(
            f"every front door {self.doors} unreachable: {last!r}")

    def predict(self, obj: dict) -> Tuple[int, dict]:
        return self.request("/predict", obj)

    def generate(self, obj: dict) -> Tuple[int, dict]:
        # client-side mirror of the door's sampling validation: a
        # malformed request never even leaves this process
        try:
            validate_sampling(obj)
        except ServingError as e:
            return e.status, {"error": e.message}
        return self.request("/generate", obj)

    def healthz(self) -> Tuple[int, dict]:
        return self.request("/healthz", method="GET")

    def fleet(self) -> Tuple[int, dict]:
        return self.request("/fleet", method="GET")

    # -------------------------------------------------------------- streamed --
    def stream_generate(self, obj: dict) -> Iterator[dict]:
        """Yield the stream's parsed ndjson lines. Door loss before the
        first token rotates to the next door; after any token the
        stream RESUMES on the next door (the request replays with
        ``resume_from`` — deterministic generation makes the suffix
        token-identical, never a duplicate). Only with every door gone
        does the stream end with the strict prefix plus one terminal
        ``{"error", "status": 503}`` dict. A door's own non-200 answer
        yields one terminal dict with the door's verdict (it is an
        answer, not a fault)."""
        payload = dict(obj)
        payload["stream"] = True
        try:
            validate_sampling(payload)
        except ServingError as e:
            yield {"error": e.message, "status": e.status}
            return
        streamed = 0
        try:
            base_resume = int(payload.get("resume_from") or 0)
        except (TypeError, ValueError):
            base_resume = 0
        last: Optional[Exception] = None
        for i, door in enumerate(self._order()):
            if i:
                self._bump("door_retries")
            if streamed > 0:
                payload["resume_from"] = base_resume + streamed
            body = json.dumps(payload).encode()
            hop = None
            try:
                hop = _http.StreamHop(
                    door, "/generate", body,
                    connect_timeout=self.timeout_s,
                    idle_timeout=self.stream_idle_timeout_s)
                if hop.status != 200:
                    data = hop.read_body()
                    try:
                        verdict = json.loads(data.decode() or "{}")
                    except ValueError:
                        verdict = {}
                    verdict.setdefault("error",
                                       f"door answered {hop.status}")
                    verdict["status"] = hop.status
                    yield verdict
                    return
                for line in hop.lines():
                    try:
                        rec = json.loads(line.decode())
                    except (ValueError, UnicodeDecodeError):
                        continue
                    if "token" in rec:
                        streamed += 1
                    yield rec
                    if "done" in rec or "error" in rec:
                        return
                # quiet EOF without a terminal line: the door vanished
                raise _http.HopError(
                    f"stream via {door} ended without a terminal line "
                    f"(front door lost mid-stream)")
            except (_http.HopError, TimeoutError, OSError) as e:
                last = e
                if streamed > 0:
                    # door-level resume: the next door replays with
                    # resume_from=streamed, so the caller's wire stays
                    # duplicate-free across the failover
                    self._bump("streams_resumed")
                continue
            finally:
                if hop is not None:
                    hop.close()
        self._bump("streams_broken")
        yield {"error": f"every front door {self.doors} unreachable "
                        f"or lost mid-stream: {last!r}"[:500],
               "status": 503}

    # ------------------------------------------------------------- metrics --
    def metrics_text(self) -> str:
        """The first answering door's merged exposition."""
        for door in self._order():
            try:
                status, _, data = _http.request(
                    door, "GET", "/metrics", timeout=self.timeout_s)
            except _http.HopError:
                continue
            if status == 200:
                return data.decode("utf-8", "replace")
        return ""

    def rows(self) -> List[Dict]:
        """The member table as the first answering door sees it (the
        convergence tests diff this across doors)."""
        status, body = self.fleet()
        return list(body.get("hosts", ())) if status == 200 else []


__all__ = ["FleetClient"]
