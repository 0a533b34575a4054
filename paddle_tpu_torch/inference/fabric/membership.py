"""Lease-based serving-fleet membership over the elastic store
(counterpart of paddle_tpu/inference/fabric/membership.py).

Hosts REGISTER ``{host_id, endpoint, capacity, pools}`` into the
elastic store (distributed/store: TCPStore / ReplicatedStore, or any
set/get/compare_set KV) and keep the record alive by heartbeat; the
front door holds a :class:`MembershipView` that turns those records
into a routed-to member table with a bounded failure ladder:

    alive --missed lease--> suspect --probe ladder / drain window-->
    evicted

Clock discipline: remote wall timestamps are never compared against
local time (cross-host clock skew would mass-evict a healthy fleet).
A heartbeat bumps a per-record ``seq``; the view records *its own*
``time.monotonic()`` whenever it observes the seq advance, and every
deadline (lease, drain) is evaluated on that observer-local monotonic
clock — the serving watchdog's rule, applied across hosts.

Suspect is a DRAIN state, not a verdict: new traffic stops, in-flight
hops finish, and the view probes the member's ``/healthz`` directly
(bounded, ``max_probes``) — a host partitioned from the *store* but
still serving answers the probe and is re-admitted (the cross-host
analogue of the watchdog's revive-before-replace ladder). Only after
the probes fail AND the drain window passes is the host evicted.

Generations: a host that re-registers (crash + relaunch, or an
eviction it never saw) bumps its record ``generation``. The view
admits a returning host_id only at a HIGHER generation than the one it
evicted, or the same generation with an ADVANCED heartbeat ``seq`` (a
corpse's seq is frozen — seq advance is proof of life, and re-admits
a host a transient bad store read wrongfully dropped as a leave) — a
stale corpse record can't haunt the table — and fleet
actuation (fabric.fleet) namespaces replica ids by (host, generation)
transitively, so completions/reports from a dead incarnation can't
clobber its replacement's.

Chaos site ``fabric.heartbeat`` fires inside every lease renewal
(raise/timeout = a flapping store path; delay = slow control plane).
"""
from __future__ import annotations

import json
import logging
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ...testing import chaos as _chaos
from ...testing.racecheck import shared_state as _shared_state

_LOG = logging.getLogger("paddle_tpu_torch.fabric")

DEFAULT_PREFIX = "fabric"

ALIVE = "alive"
SUSPECT = "suspect"
EVICTED = "evicted"


def _hosts_key(prefix: str) -> str:
    return f"{prefix}/hosts"


def _record_key(prefix: str, host_id: str) -> str:
    return f"{prefix}/host/{host_id}"


@_shared_state("generation", "draining", "_seq", "counters")
class HostLease:
    """A serving host's registration + heartbeat loop.

    ``register()`` writes the record at a generation one above any
    previous incarnation's and adds the host to the CAS-guarded index;
    the heartbeat thread then renews the lease every ``heartbeat_s``
    with a fresh ``load_fn()`` digest riding along (the router's
    least-loaded signal). ``deregister()`` is the graceful leave: the
    index entry and record are removed, so the view drops the host
    without burning its failure ladder.

    ``_lock`` guards the beat state (seq, draining bit, counters):
    ``mark_draining`` beats from the CALLER's thread while the renewal
    loop beats from its own — two unserialized ``_seq += 1`` was a
    lost update (a skipped seq advance reads as a frozen corpse to the
    view's proof-of-life rule). The record snapshot is built under the
    lock; the store write stays outside it (a lock held across a
    blocking store op couples the store's latency into every beat).
    """

    def __init__(self, store, host_id: str, endpoint: str,
                 capacity: int = 1, pools=("predict", "generate"),
                 prefix: str = DEFAULT_PREFIX, heartbeat_s: float = 0.75,
                 load_fn: Optional[Callable[[], dict]] = None):
        self.store = store
        self.host_id = str(host_id)
        self.endpoint = str(endpoint)
        self.capacity = int(capacity)
        self.pools = list(pools)
        self.prefix = prefix
        self.heartbeat_s = float(heartbeat_s)
        self.load_fn = load_fn
        self.generation = 0
        self.draining = False
        self._seq = 0
        self._lock = threading.Lock()
        # serializes whole beats (snapshot + store write): see
        # _beat_once for why the write must ride inside it
        self._beat_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.counters = {"heartbeats": 0, "heartbeat_errors": 0}

    # ---------------------------------------------------------- lifecycle --
    def register(self) -> int:
        """Write the record (generation = previous + 1) and join the
        index; starts the heartbeat thread. Returns the generation.
        Call AFTER the host's engines are warm — registration is what
        admits the host to routing (warm-before-admission, fleet
        edition)."""
        from ...distributed.store import index_add

        prev = -1
        raw = self.store.get(_record_key(self.prefix, self.host_id))
        if raw:
            try:
                prev = int(json.loads(raw).get("generation", -1))
            except (ValueError, TypeError):
                prev = -1
        with self._lock:
            self.generation = prev + 1
            self._seq = 0
            rec = self._record_locked()
        # single-writer key: only this host ever writes its own record
        # (a relaunched incarnation is ordered by process lifetime), so
        # the read-bump-write needs no CAS
        self.store.set(_record_key(self.prefix, self.host_id),
                       json.dumps(rec))
        index_add(self.store, _hosts_key(self.prefix), self.host_id)
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="fabric-heartbeat", daemon=True)
            self._thread.start()
        return self.generation

    def mark_draining(self, draining: bool = True) -> None:
        """Flip the record's draining bit (next heartbeat carries it):
        the router stops NEW traffic while in-flight work finishes."""
        with self._lock:
            self.draining = bool(draining)
        try:
            self._beat_once()
        except Exception:  # noqa: BLE001 — the regular beat retries
            pass

    def deregister(self) -> None:
        """Graceful leave: stop the heartbeat, remove index + record."""
        from ...distributed.store import index_discard

        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.heartbeat_s * 4 + 2.0)
            self._thread = None
        try:
            index_discard(self.store, _hosts_key(self.prefix),
                          self.host_id)
            self.store.delete_key(_record_key(self.prefix, self.host_id))
        except Exception:  # noqa: BLE001 — best effort on the way out
            pass

    # ---------------------------------------------------------- heartbeat --
    def _record_locked(self) -> dict:
        """Snapshot the lease record (caller holds ``_lock``)."""
        load = {}
        if self.load_fn is not None:
            try:
                load = self.load_fn() or {}
            except Exception:  # noqa: BLE001 — a sick probe must not
                load = {}      # stop the lease renewal itself
        return {
            "host_id": self.host_id,
            "endpoint": self.endpoint,
            "capacity": self.capacity,
            "pools": self.pools,
            "generation": self.generation,
            "seq": self._seq,
            "draining": self.draining,
            "ts": time.time(),  # wall timestamp, info only (never
            # compared against another clock — see module docstring)
            "load": load,
        }

    def _beat_once(self) -> None:
        _chaos.hit("fabric.heartbeat", host=self.host_id)
        # whole-beat serialization: without it, the renewal loop and a
        # mark_draining caller's beat can land their store writes out
        # of order and the LAST write may carry a stale snapshot — a
        # just-published draining=True overwritten by draining=False,
        # which keeps the router admitting new traffic for a full
        # heartbeat. With _beat_lock the later beat builds its record
        # AFTER the earlier one's write completed, so the last write is
        # always the freshest — deterministic, not retry-until-lucky.
        # Holding a lock across the store op is deliberate here and
        # confined to THIS lock: beats are a background cadence (two
        # contenders at most, store ops carry their own timeouts), and
        # the state lock `_lock` stays narrow so readers never wait on
        # the store.
        with self._beat_lock:
            with self._lock:
                self._seq += 1
                rec = self._record_locked()
            # Deliberate coupling: _beat_lock exists precisely to order
            # snapshot+write pairs (see comment above); two contenders
            # max, store ops carry their own timeouts, and the narrow
            # state lock _lock is never held across the write.
            self.store.set(_record_key(self.prefix, self.host_id),
                           json.dumps(rec))
            with self._lock:
                self.counters["heartbeats"] += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._beat_once()
            except Exception as e:  # noqa: BLE001 — a flapping store
                # path costs one renewal, not the lease loop; the view's
                # lease window absorbs bounded gaps
                with self._lock:
                    self.counters["heartbeat_errors"] += 1
                _LOG.warning("fabric heartbeat failed: %r", e)


@_shared_state("state", "last_seen", "seq", "generation", "probes",
               "suspect_since")
class Member:
    """Observer-side state for one fleet member (view-internal).

    The ladder fields above are racecheck-designated (written by the
    poll thread under the view lock, snapshotted by ``rows()``/
    ``alive()`` under the same lock). The identity/payload fields
    (endpoint, capacity, pools, draining, load) are deliberately NOT
    watched: ``adopt()`` replaces them wholesale — atomic reference
    swaps the router reads lock-free off its ``alive()`` snapshot, the
    documented published-snapshot pattern."""

    __slots__ = ("host_id", "endpoint", "capacity", "pools", "generation",
                 "seq", "state", "last_seen", "suspect_since", "probes",
                 "draining", "load")

    def __init__(self, host_id: str, rec: dict, now: float):
        self.host_id = host_id
        self.state = ALIVE
        self.last_seen = now
        self.suspect_since: Optional[float] = None
        self.probes = 0
        self.seq = -1
        self.generation = -1
        self.adopt(rec, now)

    def adopt(self, rec: dict, now: float) -> None:
        self.endpoint = str(rec.get("endpoint", ""))
        self.capacity = max(1, int(rec.get("capacity", 1)))
        self.pools = list(rec.get("pools", ()))
        self.generation = int(rec.get("generation", 0))
        self.seq = int(rec.get("seq", 0))
        self.draining = bool(rec.get("draining", False))
        self.load = dict(rec.get("load") or {})
        self.last_seen = now

    def row(self, now: float) -> dict:
        return {
            "host": self.host_id,
            "endpoint": self.endpoint,
            "state": self.state,
            "generation": self.generation,
            "capacity": self.capacity,
            "pools": list(self.pools),
            "draining": self.draining,
            "lease_age_s": round(now - self.last_seen, 3),
            "queue_depth": int(self.load.get("queue_depth", 0)),
            "replicas": int(self.load.get("replicas", 0)),
        }


def default_probe(member: Member, timeout: float = 0.75) -> bool:
    """Direct ``/healthz`` probe used on suspects: the store path may be
    partitioned while the data path still serves."""
    from . import _http

    try:
        status, _ = _http.request_json(member.endpoint, "GET", "/healthz",
                                       timeout=timeout)
    except _http.HopError:
        return False
    return status == 200


@_shared_state("_members", "_evicted_gen", "counters", "events")
class MembershipView:
    """The front door's member table, fed by store polls.

    ``poll_once(now)`` is the whole state machine (public, clock
    injectable — the chaos tests own the clock); ``start()`` runs it on
    a named daemon thread every ``lease_s / 4``. All reads
    (:meth:`alive`, :meth:`rows`) are lock-consistent snapshots.
    """

    def __init__(self, store, prefix: str = DEFAULT_PREFIX,
                 lease_s: float = 3.0, drain_s: float = 2.0,
                 max_probes: int = 2,
                 probe_fn: Optional[Callable[[Member], bool]] = None,
                 ):
        self.store = store
        self.prefix = prefix
        self.lease_s = float(lease_s)
        self.drain_s = float(drain_s)
        self.max_probes = int(max_probes)
        self.probe_fn = default_probe if probe_fn is None else probe_fn
        self._lock = threading.Lock()
        self._members: Dict[str, Member] = {}
        # host_id -> (generation, seq) at departure. A corpse record's
        # seq is FROZEN, so gen>blocked OR (gen==blocked AND seq
        # advanced) is proof of life — the latter readmits a host a
        # transient bad store read wrongfully recorded as a leave
        # (without it, seq-only heartbeats could never return).
        self._evicted_gen: Dict[str, tuple] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.counters = {"suspects": 0, "evictions": 0, "rejoins": 0,
                         "leaves": 0, "poll_errors": 0}
        self.events: "deque[dict]" = deque(maxlen=256)

    # -------------------------------------------------------------- reads --
    def alive(self, pool: Optional[str] = None) -> List[Member]:
        """Routable members: alive, not draining, serving `pool` (when
        given)."""
        with self._lock:
            out = [m for m in self._members.values()
                   if m.state == ALIVE and not m.draining]
        if pool is not None:
            out = [m for m in out if pool in m.pools]
        return sorted(out, key=lambda m: m.host_id)

    def get(self, host_id: str) -> Optional[Member]:
        with self._lock:
            return self._members.get(host_id)

    def rows(self, now: Optional[float] = None) -> List[dict]:
        if now is None:
            now = time.monotonic()
        with self._lock:
            return [m.row(now) for m in
                    sorted(self._members.values(),
                           key=lambda m: m.host_id)]

    def fleet_backlog(self) -> int:
        """Sum of members' reported queue depths (the router's shed
        signal)."""
        with self._lock:
            return sum(int(m.load.get("queue_depth", 0))
                       for m in self._members.values()
                       if m.state == ALIVE)

    def counters_snapshot(self) -> dict:
        """Lock-consistent copy of the ladder counters — the /fleet
        route and the fabric metrics wiring read these from scrape
        threads while the poll thread increments them."""
        with self._lock:
            return dict(self.counters)

    # ------------------------------------------------------- state machine --
    def _read_records(self) -> Dict[str, dict]:
        from ...distributed.store import index_members

        recs: Dict[str, dict] = {}
        for hid in index_members(self.store, _hosts_key(self.prefix)):
            raw = self.store.get(_record_key(self.prefix, hid))
            if not raw:
                continue
            try:
                recs[hid] = json.loads(raw)
            except (ValueError, TypeError):
                continue
        return recs

    def poll_once(self, now: Optional[float] = None) -> None:
        """One observe/transition pass. Store faults cost one poll, not
        the table (members age toward suspect on a silent store — which
        is correct: with the registry unreachable their freshness is
        unknowable, and the probe ladder re-checks the data path before
        anything is evicted)."""
        if now is None:
            now = time.monotonic()
        try:
            recs = self._read_records()
        except Exception as e:  # noqa: BLE001 — flapping store path
            with self._lock:
                self.counters["poll_errors"] += 1
            _LOG.warning("fabric membership poll failed: %r", e)
            recs = None
        probe_list: List[Member] = []
        with self._lock:
            if recs is not None:
                self._absorb_locked(recs, now)
            for m in list(self._members.values()):
                age = now - m.last_seen
                if m.state == ALIVE and age > self.lease_s:
                    m.state = SUSPECT
                    m.suspect_since = now
                    m.probes = 0
                    self.counters["suspects"] += 1
                    self.events.append({"event": "suspect",
                                        "host": m.host_id,
                                        "lease_age_s": round(age, 3)})
                if m.state == SUSPECT:
                    if m.probes < self.max_probes:
                        probe_list.append(m)
                    elif age > self.lease_s + self.drain_s:
                        self._evict_locked(m, age)
        # probes happen OUTSIDE the lock (they are network calls); the
        # re-admit path re-takes it
        for m in probe_list:
            m.probes += 1
            ok = False
            try:
                ok = bool(self.probe_fn(m))
            except Exception:  # noqa: BLE001 — a raising probe is a
                ok = False     # failed probe
            if ok:
                with self._lock:
                    if m.state == SUSPECT:
                        m.state = ALIVE
                        m.last_seen = now  # the injected poll clock —
                        # never the wall thread clock (clock-injectable
                        # contract; tests own `now`)
                        m.probes = 0
                        self.events.append({"event": "probe_readmit",
                                            "host": m.host_id})

    def _evict_locked(self, m: Member, age: float) -> None:
        self._evicted_gen[m.host_id] = (m.generation, m.seq)
        del self._members[m.host_id]
        self.counters["evictions"] += 1
        self.events.append({"event": "evict", "host": m.host_id,
                            "generation": m.generation,
                            "lease_age_s": round(age, 3)})

    def _absorb_locked(self, recs: Dict[str, dict], now: float) -> None:
        for hid, rec in recs.items():
            m = self._members.get(hid)
            if m is None:
                gen = int(rec.get("generation", 0))
                blocked = self._evicted_gen.get(hid)
                if blocked is not None:
                    bgen, bseq = blocked
                    if gen < bgen or (gen == bgen and
                                      int(rec.get("seq", 0)) <= bseq):
                        continue  # a dead incarnation's corpse record
                self._members[hid] = Member(hid, rec, now)
                if hid in self._evicted_gen:
                    self.counters["rejoins"] += 1
                    self.events.append({"event": "rejoin", "host": hid,
                                        "generation": gen})
                else:
                    self.events.append({"event": "join", "host": hid,
                                        "generation": gen})
                continue
            gen = int(rec.get("generation", -1))
            seq = int(rec.get("seq", -1))
            if gen > m.generation:
                # re-registered under us (crashed + relaunched before
                # we evicted): fresh incarnation, fresh ladder
                m.adopt(rec, now)
                m.state = ALIVE
                m.probes = 0
                self.counters["rejoins"] += 1
                self.events.append({"event": "rejoin", "host": hid,
                                    "generation": gen})
            elif gen == m.generation and seq > m.seq:
                m.adopt(rec, now)   # lease renewed: refresh last_seen
                if m.state == SUSPECT:
                    m.state = ALIVE
                    m.probes = 0
                    self.events.append({"event": "lease_readmit",
                                        "host": hid})
        # graceful leaves: id gone from the index entirely
        for hid in list(self._members):
            if hid not in recs:
                m = self._members.pop(hid)
                self._evicted_gen[hid] = (m.generation, m.seq)
                self.counters["leaves"] += 1
                self.events.append({"event": "leave", "host": hid})

    # ---------------------------------------------------------- lifecycle --
    def start(self) -> "MembershipView":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="fabric-membership", daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        interval = max(self.lease_s / 4.0, 0.05)
        while not self._stop.wait(interval):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the view outlives
                with self._lock:
                    self.counters["poll_errors"] += 1
                _LOG.warning("fabric membership loop failed: %r", e)

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None


__all__ = ["HostLease", "MembershipView", "Member", "default_probe",
           "ALIVE", "SUSPECT", "EVICTED", "DEFAULT_PREFIX"]
