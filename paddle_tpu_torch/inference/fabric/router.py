"""Fleet request router: the policy half of the front door
(counterpart of paddle_tpu/inference/fabric/router.py).

Routing:

- ``/predict`` goes LEAST-LOADED: score = (member-reported queue depth
  + this router's own in-flight hops to the host) / capacity. The
  member report is fresh to within one heartbeat; the local
  outstanding counter covers the window between heartbeats so a burst
  doesn't pile onto one host.
- ``/generate`` routes KV-AWARE over the decode-capable pool (the
  general "generate" pool plus specialized "decode" hosts): the score
  is projected slot occupancy in the request's capacity class — used
  slots + in-flight hops + queue weighted by expected hold time
  (1 + max_new/cap) — over total slots, from the heartbeat's per-class
  free-slot digest. Hosts without the digest fall back to the
  queue-depth score.
- streamed ``/generate`` prefers the host whose PREFIX CACHE already
  holds the request's prompt head (the heartbeat residency digest —
  longest matching boundary wins, host-id ties break low), falling
  back to the CONSISTENT HASH of the prompt (or the client's
  ``session`` field): a conversation's turns keep landing where their
  KV state is warm, and a host join/leave only remaps the ring
  segment it owned.
- with BOTH specialized pools live (``prefill`` + ``decode``), a
  streamed /generate runs disaggregated: the prompt prefills on a
  prefill-pool host (``prefill_only`` — the reply is a KV-handoff
  payload, not tokens), the payload imports into a decode host's
  ``/admin/kv`` plane, and the decode host's stream is relayed. The
  split is best-effort: any prefill-side fault falls back to the
  plain single-host path.

Failure rules (the ``streamed == 0`` rule, upgraded by the
KV-handoff subsystem from strict-prefix to seamless resume):

- a transport fault (connect refused / reset / hop timeout) on a
  request that has NOT streamed anything is retried ONCE on a
  different host — predict and greedy generation are pure, so
  re-execution is safe, and the one-retry bound keeps a sick fleet
  from turning into a retry storm;
- a stream that already delivered tokens REPLAY-RESUMES on a survivor:
  generation is deterministic end-to-end (the 1-split-per-token
  key-chain law, seeded or greedy), so the original request replays
  with ``resume_from=<tokens already on the wire>`` and the survivor
  re-derives the identical stream, emitting only the unseen suffix —
  zero duplicate tokens, zero gaps. Only when NO survivor exists does
  the break surface as a terminal error line;
- a draining member that emits a terminal ``handoff`` line (live
  migration) has its payload imported into a survivor and the relay
  splices the continued stream — the client never sees the move;
- a member's OWN HTTP answer (4xx/5xx) is passed through untouched —
  it is an answer, not a fault (a member's 503 carries its own
  Retry-After).

Degrade order stays SCALE -> QUEUE -> SHED fleet-wide: while an
attached fleet autoscaler reports headroom, the fleet queue bound
stretches before anything sheds; zero live members is a 503 with
Retry-After = the lease window (the soonest membership can change).

Chaos site ``fabric.forward`` fires before every hop with
``host=``/``path=`` context, so a rule can fault one host's hops.
"""
from __future__ import annotations

import bisect
import hashlib
import json
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from ...observability import trace as _tr
from ...testing import chaos as _chaos
from ...testing.racecheck import shared_state as _shared_state
from ..serving.lifecycle import ServingError
from . import _http
from . import handoff as _handoff
from .membership import Member, MembershipView
from .metrics import FabricMetrics, track_router


def _hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")


def build_ring(host_ids: Iterable[str],
               vnodes: int = 32) -> List[Tuple[int, str]]:
    """Consistent-hash vnode ring: sorted ``(hash, host_id)`` points,
    ``vnodes`` per host. Stable for a fixed host set; a join/leave
    remaps only the ring segments the changed host owns. The reference
    shares it between the stream-affinity router below and its
    embedding shard tier, so both tenants agree on ownership."""
    ring: List[Tuple[int, str]] = []
    for hid in host_ids:
        for v in range(vnodes):
            ring.append((_hash64(f"{hid}#{v}".encode()), hid))
    ring.sort(key=lambda t: t[0])
    return ring


def ring_hosts(ring: List[Tuple[int, str]], key: bytes,
               n: int = 1) -> List[str]:
    """The first ``n`` DISTINCT hosts clockwise from ``key``'s point —
    ring_hosts(ring, k, 1)[0] is the owner, the rest are the successor
    hosts a fan-out retries onto when the owner is unreachable."""
    if not ring:
        return []
    k = _hash64(key)
    start = bisect.bisect_left(ring, (k, ""))
    out: List[str] = []
    for i in range(len(ring)):
        hid = ring[(start + i) % len(ring)][1]
        if hid not in out:
            out.append(hid)
            if len(out) >= n:
                break
    return out


@_shared_state("_outstanding")
class FabricRouter:
    """Stateless-per-request router over a :class:`MembershipView`."""

    def __init__(self, view: MembershipView,
                 metrics: Optional[FabricMetrics] = None,
                 hop_timeout_s: float = 30.0,
                 stream_idle_timeout_s: float = 60.0,
                 max_fleet_queue: int = 256,
                 overload_queue_factor: float = 2.0,
                 retry_after_s: float = 0.5,
                 retry_after_max_s: float = 30.0,
                 vnodes: int = 32):
        self.view = view
        self.metrics = metrics or FabricMetrics()
        self.hop_timeout_s = float(hop_timeout_s)
        self.stream_idle_timeout_s = float(stream_idle_timeout_s)
        self.max_fleet_queue = int(max_fleet_queue)
        self.overload_queue_factor = max(1.0, float(overload_queue_factor))
        self.retry_after_s = float(retry_after_s)
        self.retry_after_max_s = float(retry_after_max_s)
        self.vnodes = int(vnodes)
        # fleet autoscaler hook (fabric.fleet wires the ReplicaAutoscaler
        # here): remaining scale-up headroom stretches the queue bound
        self.scale_headroom_fn = None
        self._lock = threading.Lock()
        self._outstanding: Dict[str, int] = {}
        self.metrics.member_rows_fn = self.view.rows
        # lock-consistent reads: the scrape thread walks these while
        # the poll thread / request threads mutate under their locks
        self.metrics.membership_counters_fn = self.view.counters_snapshot
        self.metrics.outstanding_fn = self._outstanding_total
        track_router(self)

    def _outstanding_total(self) -> int:
        with self._lock:
            return sum(self._outstanding.values())

    # ---------------------------------------------------------- selection --
    def _score(self, m: Member) -> float:
        with self._lock:
            mine = self._outstanding.get(m.host_id, 0)
        return (int(m.load.get("queue_depth", 0)) + mine) / \
            float(max(m.capacity, 1))

    def _alive_generate(self, skip: set) -> List[Member]:
        """Decode-capable members: the general "generate" pool plus
        specialized "decode" hosts, deduped, host-id order (the order
        only breaks exact score ties, but it must be deterministic)."""
        out: List[Member] = []
        seen = set()
        for pool in ("generate", "decode"):
            for m in self.view.alive(pool):
                if m.host_id in seen or m.host_id in skip:
                    continue
                seen.add(m.host_id)
                out.append(m)
        out.sort(key=lambda m: m.host_id)
        return out

    def _kv_score(self, m: Member, total: int, max_new: int) -> float:
        """Projected KV-slot occupancy for a request needing ``total``
        positions: used slots + our in-flight hops + queued requests
        weighted by expected hold time (a long decode occupies its
        slot for ~max_new steps), over the class's slot count. Falls
        back to the queue-depth score for a host without the digest
        (pre-upgrade member mid-rollout)."""
        kv = m.load.get("kv")
        if not isinstance(kv, dict) or not kv:
            return self._score(m)
        caps = sorted(int(c) for c in kv if int(c) >= total)
        if not caps:
            # no class fits: route only as a last resort (the member
            # itself will 400/shed) — rank after every fitting host
            return 1e9 + self._score(m)
        cap = caps[0]
        ent = kv[str(cap)]
        slots = max(int(ent.get("slots", 0)), 1)
        used = slots - int(ent.get("free", 0))
        with self._lock:
            mine = self._outstanding.get(m.host_id, 0)
        queue = int(m.load.get("queue_depth", 0))
        hold = 1.0 + float(max_new) / float(cap)
        return (used + mine + queue * hold) / float(slots)

    def _residency_host(self, alive: List[Member],
                        prompt) -> Optional[Member]:
        """The member whose heartbeat residency digest says its prefix
        cache already holds a head of ``prompt``. Longest matching
        boundary wins; equal boundaries break on the LOWEST host id
        (deterministic — the streamed-affinity tests pin this). None
        when no digest matches: the ring decides."""
        if not prompt:
            return None
        hashes: Dict[int, str] = {}

        def h8(f: int) -> str:
            if f not in hashes:
                hashes[f] = _handoff.prefix_hash(prompt, f)[:8]
            return hashes[f]

        best = None   # (boundary, host_id, member)
        for m in alive:
            for ent in m.load.get("prefix") or ():
                try:
                    fs, want = str(ent).split(":", 1)
                    f = int(fs)
                except ValueError:
                    continue
                if f <= 0 or len(prompt) < f or h8(f) != want:
                    continue
                if best is None or f > best[0] or \
                        (f == best[0] and m.host_id < best[1]):
                    best = (f, m.host_id, m)
        return best[2] if best else None

    def pick(self, pool: Optional[str] = None,
             exclude: Iterable[str] = (),
             affinity_key: Optional[bytes] = None,
             gen_req: Optional[dict] = None) -> Optional[Member]:
        """Choose a routable member; None when the fleet has none.
        ``gen_req`` (``{"input_ids", "max_new_tokens"}``) switches
        generation picks to the KV-aware score and residency-first
        affinity."""
        skip = set(exclude)
        if pool == "generate":
            alive = self._alive_generate(skip)
        else:
            alive = [m for m in self.view.alive(pool)
                     if m.host_id not in skip]
        if not alive:
            return None
        if gen_req is not None:
            prompt = gen_req.get("input_ids") or []
            max_new = max(int(gen_req.get("max_new_tokens") or 0), 1)
            if affinity_key is not None:
                m = self._residency_host(alive, prompt)
                if m is not None:
                    return m
            else:
                total = len(prompt) + max_new
                return min(alive, key=lambda mm:
                           self._kv_score(mm, total, max_new))
        if affinity_key is None:
            return min(alive, key=self._score)
        # consistent-hash ring over the CURRENT alive set: stable for a
        # fixed fleet, minimal remap on join/leave. Built per pick — the
        # fleet is small (tens of hosts) and the alive set changes under
        # the membership ladder, so a cached ring would chase it anyway.
        by_id = {m.host_id: m for m in alive}
        ring = build_ring(sorted(by_id), self.vnodes)
        return by_id[ring_hosts(ring, affinity_key, 1)[0]]

    # -------------------------------------------------------------- gates --
    def _fleet_bound(self) -> int:
        fn = self.scale_headroom_fn
        if fn is not None:
            try:
                if int(fn()) > 0:
                    return int(self.max_fleet_queue *
                               self.overload_queue_factor)
            except Exception:  # noqa: BLE001 — a sick headroom probe
                pass           # must not break the breaker itself
        return self.max_fleet_queue

    def _retry_after(self) -> float:
        depth = self.view.fleet_backlog()
        qps_lat = self.metrics.latency_percentiles()["p50"]
        if depth <= 0 or qps_lat <= 0:
            return self.retry_after_s
        est = depth * qps_lat
        return min(max(est, self.retry_after_s), self.retry_after_max_s)

    def _gate(self, route: str) -> None:
        """Admission: no-host refusal and the fleet-wide breaker."""
        self.metrics.on_request(route)
        if not self.view.alive():
            self.metrics.on_no_host()
            raise ServingError(
                503, "no live serving hosts in the fleet",
                retry_after=self.view.lease_s)
        backlog = self.view.fleet_backlog()
        with self._lock:
            backlog += sum(self._outstanding.values())
        if backlog >= self._fleet_bound():
            self.metrics.on_shed()
            raise ServingError(
                503, f"fleet backlog {backlog} at bound "
                     f"{self._fleet_bound()} — load shed",
                retry_after=self._retry_after())

    def _begin_hop(self, host_id: str) -> None:
        with self._lock:
            self._outstanding[host_id] = \
                self._outstanding.get(host_id, 0) + 1

    def _end_hop(self, host_id: str) -> None:
        with self._lock:
            n = self._outstanding.get(host_id, 1) - 1
            if n <= 0:
                self._outstanding.pop(host_id, None)
            else:
                self._outstanding[host_id] = n

    # ------------------------------------------------------- non-streamed --
    def forward(self, path: str, body: bytes, ctype: str,
                pool: Optional[str] = None,
                parent_ctx=None,
                gen_req: Optional[dict] = None
                ) -> Tuple[int, Dict[str, str], bytes]:
        """Forward one non-streamed request; returns the member's
        (status, headers, body) verbatim. One bounded retry on another
        host for transport faults (never for member answers)."""
        self._gate(path.lstrip("/"))
        excluded: List[str] = []
        last_err: Optional[Exception] = None
        for attempt in range(2):
            m = self.pick(pool, exclude=excluded, gen_req=gen_req)
            if m is None:
                break
            excluded.append(m.host_id)
            t0 = time.monotonic()
            self._begin_hop(m.host_id)
            try:
                _chaos.hit("fabric.forward", host=m.host_id, path=path)
                with _tr.span("fabric.forward", "fabric",
                              {"host": m.host_id, "path": path,
                               "attempt": attempt}, parent=parent_ctx):
                    status, headers, data = _http.request(
                        m.endpoint, "POST", path, body, ctype=ctype,
                        timeout=self.hop_timeout_s)
            except (_http.HopError, TimeoutError, OSError) as e:
                last_err = e
                if attempt == 0:
                    self.metrics.on_retry()
                continue
            finally:
                self._end_hop(m.host_id)
            self.metrics.on_forward(m.host_id)
            if status < 500:
                self.metrics.on_hop_ok(time.monotonic() - t0)
            return status, headers, data
        self.metrics.on_failed()
        raise ServingError(
            503, f"fleet forward failed after {len(excluded) or 1} "
                 f"host(s): {last_err!r}"[:2000],
            retry_after=self._retry_after())

    # ----------------------------------------------------------- streamed --
    @staticmethod
    def _resume_body(body: bytes, streamed: int) -> bytes:
        """The replay-resume request: the ORIGINAL body plus
        ``resume_from`` = tokens already on the client's wire. The
        survivor re-derives the identical stream (deterministic
        key-chain) and emits only the unseen suffix."""
        if streamed <= 0:
            return body
        try:
            obj = json.loads(body.decode())
        except (ValueError, UnicodeDecodeError):
            return body
        # ADDITIVE: a door-level resume may already carry resume_from
        # (tokens a previous door delivered) — this relay's count
        # stacks on top, keeping the client's offset exact
        try:
            base = int(obj.get("resume_from") or 0)
        except (TypeError, ValueError):
            base = 0
        obj["resume_from"] = base + int(streamed)
        return json.dumps(obj).encode()

    def _prefill_handoff(self, body: bytes,
                         parent_ctx=None) -> Optional[bytes]:
        """Disaggregated first leg: run the prompt as ``prefill_only``
        on a prefill-pool host and return the KV-handoff payload to
        import into a decode host. Best-effort — ANY fault returns
        None and the caller falls back to the plain single-host path
        (specialization must never fail a request the decode pool
        could serve alone)."""
        try:
            obj = json.loads(body.decode())
            obj.pop("stream", None)
            obj["prefill_only"] = True
        except (ValueError, UnicodeDecodeError):
            return None
        excluded: List[str] = []
        for attempt in range(2):
            m = self.pick("prefill", exclude=excluded)
            if m is None:
                return None
            excluded.append(m.host_id)
            t0 = time.monotonic()
            self._begin_hop(m.host_id)
            try:
                _chaos.hit("fabric.forward", host=m.host_id,
                           path="/generate")
                with _tr.span("fabric.prefill", "fabric",
                              {"host": m.host_id, "attempt": attempt},
                              parent=parent_ctx):
                    status, res = _http.request_json(
                        m.endpoint, "POST", "/generate", obj,
                        timeout=self.hop_timeout_s)
            except (_http.HopError, TimeoutError, OSError):
                self.metrics.on_retry()
                continue
            finally:
                self._end_hop(m.host_id)
            self.metrics.on_forward(m.host_id)
            if status != 200 or "handoff" not in res:
                return None
            self.metrics.on_hop_ok(time.monotonic() - t0)
            try:
                raw = _handoff.from_b64(res["handoff"])
            except (ValueError, TypeError):
                return None
            self.metrics.on_prefill_handoff()
            return raw
        return None

    def _relay_lines(self, hop, m: Member, emit,
                     st: dict) -> Tuple[str, Optional[bytes]]:
        """Relay one member stream until its terminal line. Returns
        ("done", None) for a finished/errored stream, or ("handoff",
        raw_payload) when a draining member migrated it (the handoff
        line is consumed here — the client never sees it). A missing
        terminal line raises HopError: host lost mid-stream."""
        terminated = None
        handoff_raw = None
        for line in hop.lines():
            if line.startswith(b'{"token"'):
                emit(line)
                st["streamed"] += 1
                continue
            # non-token lines are rare (one per stream): parse to
            # recognize the protocol's terminal {"done"} / {"error"} /
            # {"handoff"} line
            try:
                obj = json.loads(line.decode())
            except (ValueError, UnicodeDecodeError):
                obj = {}
            if "handoff" in obj and "done" not in obj:
                try:
                    handoff_raw = _handoff.from_b64(obj["handoff"])
                except (ValueError, TypeError) as e:
                    raise _http.HopError(
                        f"bad handoff payload from {m.host_id}: "
                        f"{e!r}"[:500]) from None
                terminated = "handoff"
                continue
            emit(line)
            if "done" in obj or "error" in obj:
                terminated = "done"
        if terminated is None:
            # a truncated chunked stream reads as quiet EOF
            # (http.client's readline swallows IncompleteRead) — the
            # missing terminal line IS the host-loss signal
            raise _http.HopError(
                f"stream from {m.host_id} ended without a terminal "
                f"line (host lost mid-stream)")
        return terminated, handoff_raw

    def stream_generate(self, body: bytes, affinity_key: bytes,
                        emit, parent_ctx=None,
                        gen_req: Optional[dict] = None) -> None:
        """Relay a streamed /generate: ``emit(line_bytes)`` is called
        per ndjson line as the member produces it.

        The hop plan is a small state machine: a ("generate", body)
        hop on a decode-capable member, or an ("import", payload) hop
        shipping a KV-handoff into a survivor's /admin/kv plane. Host
        loss replay-resumes (resume_from suppresses every token
        already on the wire — zero duplicates); a draining member's
        terminal handoff line re-homes via import; with live prefill
        AND decode pools the first leg prefills remotely and the plan
        STARTS at import. Raises ServingError only when nothing was
        emitted; with tokens on the wire an exhausted fleet surfaces
        as a terminal error line."""
        self._gate("generate_stream")
        excluded: List[str] = []
        st = {"streamed": 0}
        last_err: Optional[Exception] = None
        action: Tuple[str, bytes] = ("generate", body)
        if self.view.alive("prefill") and self.view.alive("decode"):
            raw = self._prefill_handoff(body, parent_ctx)
            if raw is not None:
                action = ("import", raw)
        # 4 hops bound the cascade: prefill handoff + a migration +
        # a resume + one more loss still terminates deterministically
        for attempt in range(4):
            kind, payload = action
            aff = affinity_key if (kind == "generate" and
                                   attempt == 0) else None
            m = self.pick("generate", exclude=excluded,
                          affinity_key=aff, gen_req=gen_req)
            if m is None:
                break
            excluded.append(m.host_id)
            if kind == "import":
                path, hop_body = "/admin/kv/import", payload
                ctype = "application/octet-stream"
            else:
                path = "/generate"
                hop_body = self._resume_body(payload, st["streamed"])
                ctype = "application/json"
            hop = None
            self._begin_hop(m.host_id)
            try:
                _chaos.hit("fabric.forward", host=m.host_id, path=path)
                with _tr.span("fabric.forward", "fabric",
                              {"host": m.host_id, "path": path,
                               "stream": True, "attempt": attempt},
                              parent=parent_ctx):
                    hop = _http.StreamHop(
                        m.endpoint, path, hop_body,
                        connect_timeout=self.hop_timeout_s,
                        idle_timeout=self.stream_idle_timeout_s,
                        ctype=ctype)
                    if hop.status != 200:
                        # the member ANSWERED (shed, bad request...):
                        # pass its verdict through, don't burn the retry
                        data = hop.read_body()
                        self.metrics.on_forward(m.host_id)
                        try:
                            obj = json.loads(data.decode() or "{}")
                        except ValueError:
                            obj = {}
                        raise ServingError(
                            hop.status,
                            obj.get("error",
                                    f"member answered {hop.status}"),
                            retry_after=obj.get("retry_after"))
                    outcome, handoff_raw = self._relay_lines(
                        hop, m, emit, st)
                    self.metrics.on_forward(m.host_id)
                    if outcome == "done":
                        self.metrics.on_stream(st["streamed"],
                                               broken=False)
                        return
                    # live migration: the draining member exported the
                    # stream's KV state — re-home it on a survivor
                    self.metrics.on_migrated()
                    action = ("import", handoff_raw)
                    continue
            except ServingError as e:
                last_err = e
                if kind == "generate" and st["streamed"] == 0:
                    raise   # the member's verdict passes through
                # an import/resume target ANSWERED (shed, geometry
                # conflict...): fall back to running the request whole
                # on a survivor — a failed handoff must never fail
                # what a plain host could serve, and resume_from keeps
                # the wire duplicate-free
                action = ("generate", body)
                continue
            except (_http.HopError, TimeoutError, OSError) as e:
                last_err = e
                if st["streamed"] == 0 and kind == "generate":
                    if attempt == 0:
                        self.metrics.on_retry()
                        continue
                    break   # pre-stream: the plain one-retry rule
                # tokens already on the wire (or a lost handoff hop):
                # replay-resume the ORIGINAL request on a survivor —
                # the deterministic key-chain re-derives the stream
                # and resume_from keeps the wire duplicate-free
                self.metrics.on_resumed()
                action = ("generate", body)
                continue
            finally:
                self._end_hop(m.host_id)
                if hop is not None:
                    hop.close()
        self.metrics.on_failed()
        if st["streamed"] > 0:
            # every decode-capable host is gone: terminal error line
            # (the 200 is committed — the error can only ride the
            # stream); the client got a strict prefix, never a dupe
            self.metrics.on_stream(st["streamed"], broken=True)
            emit(json.dumps(
                {"error": f"serving host lost mid-stream and no "
                          f"survivor could resume: {last_err!r}"[:500],
                 "status": 503}).encode())
            return
        raise ServingError(
            503, f"fleet stream failed after {len(excluded) or 1} "
                 f"host(s): {last_err!r}"[:2000],
            retry_after=self._retry_after())


__all__ = ["FabricRouter", "build_ring", "ring_hosts"]
