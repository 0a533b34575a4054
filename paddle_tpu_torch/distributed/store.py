"""TCPStore, the rendezvous KV store (counterpart of
paddle_tpu/distributed/store.py): a ctypes binding over cpp/tcpstore.cc,
the in-process fallback, the replicated and the quorum store, and the
CAS-guarded JSON indexes the fabric's membership registry rides on.

The library is built at first use from `cpp/tcpstore.cc` alone (`g++ -O2
-fPIC -std=c++17 -pthread -shared`) into `<checkout>/build/store/`, named
by the hash of the source and the flags, under a file lock: several host
processes starting at once build it once. Without a compiler the store
falls back to a pure-Python in-process implementation (one process only).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import random
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

from ..core.flags import flag as _flag
from ..testing import chaos as _chaos
from ..testing.racecheck import shared_state

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "cpp" / "tcpstore.cc"
BUILD_DIR = _ROOT / "build" / "store"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")

_LIB = None
_LIB_LOCK = threading.Lock()
# counters of the retry loop (the reference's fault-tolerance counters)
COUNTERS = {"store_retries": 0}

_OPS = {"SET": 0, "GET": 1, "ADD": 2, "WAIT": 3, "DELETE": 4,
        "COMPARE_SET": 5, "EXISTS_GET": 6, "KEYS": 7}


def lib_path() -> Path:
    """Where the library built from the current source lands."""
    digest = hashlib.sha256(_SOURCE.read_bytes() +
                            " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtcpstore_{digest[:16]}.so"


def _build(target: Path) -> None:
    """Compile cpp/tcpstore.cc into `target` under an exclusive file lock
    (another process may be building it); raise if g++ fails."""
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build_lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            if target.exists():
                return
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError("no C++ compiler (g++) on PATH")
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            out = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed to build tcpstore.cc "
                                   f"(exit {out.returncode}):\n{out.stdout}")
            # rename, never rewrite: a live process may have the old file
            # mapped
            os.replace(tmp, target)
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def _load_lib():
    """The native library (built first if needed), or None when it cannot
    be built or loaded: the store then runs on the in-process fallback."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        try:
            target = lib_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
        except (OSError, RuntimeError):
            return None
        lib.tcpstore_server_start.restype = ctypes.c_void_p
        lib.tcpstore_server_start.argtypes = [ctypes.c_int,
                                              ctypes.POINTER(ctypes.c_int)]
        lib.tcpstore_server_stop.argtypes = [ctypes.c_void_p]
        lib.tcpstore_client_connect.restype = ctypes.c_void_p
        lib.tcpstore_client_connect.argtypes = [ctypes.c_char_p,
                                                ctypes.c_int, ctypes.c_int]
        lib.tcpstore_client_close.argtypes = [ctypes.c_void_p]
        lib.tcpstore_request.restype = ctypes.c_int
        lib.tcpstore_request.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        _LIB = lib
        return lib


def retry_transient(fn, *, attempts: int = 3,
                    timeout: Optional[float] = None, base: float = 0.05,
                    factor: float = 2.0,
                    transient=(ConnectionError, OSError, RuntimeError),
                    counter: str = "store_retries", on_retry=None):
    """Run `fn` with bounded exponential backoff and jitter on transient
    errors (the reference's fault_tolerance.retry_transient). TimeoutError
    (an OSError, but a semantic "not yet") propagates at once; a retry
    whose backoff would pass `timeout` is not taken. `on_retry` (its own
    errors swallowed) runs between attempts: TCPStore's reconnect."""
    attempts = max(1, int(attempts))
    deadline = None if timeout is None else time.monotonic() + timeout
    delay = base
    for k in range(attempts):
        try:
            return fn()
        except TimeoutError:
            raise
        except transient:
            if k + 1 >= attempts:
                raise
            sleep = delay * (0.5 + random.random())  # jitter in [0.5, 1.5)
            if deadline is not None and \
                    time.monotonic() + sleep >= deadline:
                raise
            COUNTERS[counter] = COUNTERS.get(counter, 0) + 1
            time.sleep(sleep)
            delay *= factor
            if on_retry is not None:
                try:
                    on_retry()
                except Exception:  # noqa: BLE001 — the next attempt's
                    pass           # fn() raises the real error


def _parse_endpoints(spec) -> list:
    """Normalize an endpoint spec — a ``"h:p, h:p"`` string or a list
    of strings/(host, port) pairs — to ``[(host, port), ...]``. One
    parser for ReplicatedStore/QuorumStore/make_store: per-entry strip
    matters (docs show spaced comma lists; a ``" h"`` host fails
    getaddrinfo and silently halves the fault margin), and bare
    ``":port"``/``"port"`` entries default to 127.0.0.1."""
    if isinstance(spec, str):
        spec = [e for e in spec.split(",") if e.strip()]
    out = []
    for ep in spec:
        if isinstance(ep, (tuple, list)):
            out.append((ep[0], int(ep[1])))
        else:
            host, _, port = str(ep).strip().rpartition(":")
            out.append((host or "127.0.0.1", int(port)))
    return out


class StoreReplyTooLarge(Exception):
    """A store reply overflowed the client buffer — a deterministic
    data-shape error, deliberately NOT an OSError/RuntimeError so retry
    and failover layers never mistake it for a dead socket."""


class QuorumLostError(RuntimeError):
    """Fewer than quorum members reachable. RuntimeError for callers
    (the documented store-down surface), but failover paths re-raise it
    instead of treating it as ONE member's death."""


class _PyFallbackStore:
    """In-process fallback (single-host tests without a toolchain)."""

    def __init__(self):
        self.kv = {}
        self.cv = threading.Condition()

    def set(self, k, v):
        with self.cv:
            self.kv[k] = v
            self.cv.notify_all()

    def get(self, k):
        with self.cv:
            return self.kv.get(k, b"")

    def add(self, k, delta):
        with self.cv:
            now = int(self.kv.get(k, b"0")) + delta
            self.kv[k] = str(now).encode()
            self.cv.notify_all()
            return now

    def wait(self, k, timeout=None):
        with self.cv:
            ok = self.cv.wait_for(lambda: k in self.kv, timeout)
            if not ok:
                raise TimeoutError(f"wait({k!r}) timed out")
            return self.kv[k]

    def keys(self, prefix=""):
        with self.cv:
            return sorted(k for k in self.kv if k.startswith(prefix))


class TCPStore:
    """paddle-style TCPStore.

    is_master=True starts the C++ server in-process; every instance connects
    a client. world_size enables the barrier helper.

    Client ops retry transient connect/reset errors (bounded attempts,
    exponential backoff + jitter, total time capped by the op timeout —
    `FLAGS_store_retry_attempts`); TimeoutError is the semantic "not yet"
    answer and never retries. Non-idempotent `add` never retries AT ALL:
    once the request may have been sent, "did the server apply it?" is
    unknowable and a replay could double-count (the constructor's connect
    is retried for every op). Every op passes a `store.<op>` chaos
    injection point carrying the endpoint, so tests kill exactly one
    replica.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 30.0,
                 retry_attempts: Optional[int] = None):
        self.world_size = world_size
        self.timeout = timeout
        # None -> FLAGS_store_retry_attempts; ReplicatedStore passes 1
        # for its member clients (IT owns failover — stacking a client
        # retry under it would stall heartbeats ~0.25s per dead-replica
        # contact and erode the elastic staleness budget)
        self._retry_attempts = retry_attempts
        lib = _load_lib()
        self._server = None
        self._client = None
        self._py: Optional[_PyFallbackStore] = None
        if lib is None:
            self._py = _GLOBAL_PY_STORE
            self.host, self.port = host, port
            return
        if is_master:
            actual = ctypes.c_int(0)
            self._server = lib.tcpstore_server_start(port,
                                                     ctypes.byref(actual))
            if not self._server:
                raise RuntimeError(f"TCPStore: cannot bind port {port}")
            port = actual.value
        self.host, self.port = host, port
        self._lock = threading.Lock()
        self._with_retry("connect", self._reconnect)

    def _reconnect(self):
        """(Re)establish the native client connection — the retry path
        after a reset; a still-down server raises to trigger backoff."""
        lib = _load_lib()
        with self._lock:
            if self._client:
                try:
                    lib.tcpstore_client_close(self._client)
                except Exception:  # noqa: BLE001
                    pass
                self._client = None
            c = lib.tcpstore_client_connect(
                self.host.encode(), self.port, int(self.timeout * 1000))
            if not c:
                raise RuntimeError(
                    f"TCPStore: cannot connect {self.host}:{self.port}")
            self._client = c

    def _with_retry(self, op: str, fn, idempotent: bool = True,
                    timeout: Optional[float] = None):
        """Bounded retry (fault_tolerance.retry_transient: exp backoff +
        jitter, TimeoutError passthrough) on transient errors, total time
        capped by this store's timeout — or `timeout` when the caller
        holds a tighter deadline (wait()'s poll loop); each attempt
        passes the `store.<op>` chaos site and a failed attempt
        reconnects the native client before the next one."""
        endpoint = f"{self.host}:{self.port}"

        def attempt():
            _chaos.hit(f"store.{op}", endpoint=endpoint)
            return fn()

        reconnect = self._reconnect \
            if self._py is None and op != "connect" else None
        attempts = self._retry_attempts if self._retry_attempts \
            is not None else int(_flag("store_retry_attempts"))
        return retry_transient(
            attempt, attempts=max(1, attempts) if idempotent else 1,
            timeout=self.timeout if timeout is None else timeout,
            transient=(OSError, RuntimeError),
            counter="store_retries", on_retry=reconnect)

    def _request(self, op: str, key: str, val: bytes = b"") -> bytes:
        lib = _load_lib()
        cap = 1 << 20
        out = ctypes.create_string_buffer(cap)
        with self._lock:
            if not self._client:
                # a failed _reconnect leaves no live handle — passing the
                # NULL through ctypes would segfault in the C client
                raise ConnectionError(
                    f"TCPStore: not connected to {self.host}:{self.port}")
            n = lib.tcpstore_request(self._client, _OPS[op], key.encode(),
                                     len(key.encode()), val, len(val), out, cap)
        if n < 0:
            raise RuntimeError(f"TCPStore request {op} {key} failed")
        if n > cap:
            # the C shim reports the FULL reply size while copying only
            # cap bytes — returning the truncated prefix silently would
            # corrupt the value (a KEYS reply would drop members). A
            # DEDICATED type (not RuntimeError): failover layers treat
            # RuntimeError as "dead socket", and this deterministic
            # caller-side error must not walk healthy members dead.
            raise StoreReplyTooLarge(
                f"TCPStore reply for {op} {key} is {n} bytes, over the "
                f"{cap}-byte client buffer")
        return out.raw[:n]

    def set(self, key: str, value):
        v = value if isinstance(value, bytes) else str(value).encode()
        if self._py is not None:
            return self._with_retry("set", lambda: self._py.set(key, v))
        self._with_retry("set", lambda: self._request("SET", key, v))

    def get(self, key: str) -> bytes:
        if self._py is not None:
            return self._with_retry("get", lambda: self._py.get(key))
        return self._with_retry("get", lambda: self._request("GET", key))

    def add(self, key: str, delta: int = 1) -> int:
        if self._py is not None:
            return self._with_retry("add", lambda: self._py.add(key, delta),
                                    idempotent=False)
        import struct

        return int(self._with_retry(
            "add",
            lambda: self._request("ADD", key, struct.pack("<q", delta)),
            idempotent=False))

    def wait(self, key: str, timeout: Optional[float] = None) -> bytes:
        if self._py is not None:
            # the retry budget is the CALLER's wait deadline, matching
            # the native poll path below
            t = timeout or self.timeout
            return self._with_retry(
                "wait", lambda: self._py.wait(key, t), timeout=t)
        # Poll EXISTS_GET under a deadline rather than the server's
        # blocking WAIT op: WAIT holds the connection with no timeout, so
        # a key that never arrives would hang this client forever and the
        # TimeoutError contract (which ReplicatedStore's failover logic
        # distinguishes from a dead socket) could never fire on the
        # native path. EXISTS_GET's presence prefix keeps a key set to
        # b"" distinguishable from a missing one (plain GET replies
        # vlen=0 for both).
        deadline = time.monotonic() + (timeout or self.timeout)
        while True:
            # each poll is individually retried (and a `store.wait` chaos
            # hit); the retry budget is the REMAINING wait deadline, not
            # the store timeout — a flapping connection must not stretch
            # a 0.5s wait to 30s before the TimeoutError fires
            v = self._with_retry(
                "wait", lambda: self._request("EXISTS_GET", key),
                timeout=max(0.01, deadline - time.monotonic()))
            if v[:1] == b"\x01":
                return v[1:]
            if time.monotonic() >= deadline:
                raise TimeoutError(f"wait({key!r}) timed out")
            time.sleep(0.01)

    def _py_compare_set(self, key: str, expected: str, desired: str):
        with self._py.cv:
            cur = self._py.kv.get(key, b"")
            if cur == expected.encode():
                self._py.kv[key] = desired.encode()
                self._py.cv.notify_all()
                return desired.encode()
            return cur

    def compare_set(self, key: str, expected: str, desired: str) -> bytes:
        # safe to retry: replaying a WON CAS observes current==desired and
        # still reports the desired value; a lost one reports the winner
        if self._py is not None:
            return self._with_retry(
                "compare_set",
                lambda: self._py_compare_set(key, expected, desired))
        return self._with_retry(
            "compare_set",
            lambda: self._request(
                "COMPARE_SET", key,
                expected.encode() + b"\0" + desired.encode()))

    def _py_delete(self, key: str):
        with self._py.cv:
            self._py.kv.pop(key, None)

    def delete_key(self, key: str):
        if self._py is not None:
            return self._with_retry("delete",
                                    lambda: self._py_delete(key))
        self._with_retry("delete", lambda: self._request("DELETE", key))

    def keys(self, prefix: str = "") -> list:
        """All key names (optionally under `prefix`) — the enumeration
        QuorumStore's rejoin-resync rides (server op KEYS)."""
        if self._py is not None:
            return self._with_retry("keys", lambda: self._py.keys(prefix))
        raw = self._with_retry("keys",
                               lambda: self._request("KEYS", prefix))
        return sorted(raw.decode().split("\n")) if raw else []

    def barrier(self, name: str = "barrier", timeout: Optional[float] = None):
        """All world_size participants arrive, then proceed."""
        n = self.add(f"__{name}_cnt", 1)
        gen = (n - 1) // self.world_size
        target = (gen + 1) * self.world_size
        deadline = time.monotonic() + (timeout or self.timeout)
        while time.monotonic() < deadline:
            if int(self.get(f"__{name}_cnt") or b"0") >= target:
                return
            time.sleep(0.01)
        raise TimeoutError(f"barrier {name} timed out ({n}/{target})")

    def stop(self):
        lib = _load_lib()
        if self._client and lib:
            lib.tcpstore_client_close(self._client)
            self._client = None
        if self._server and lib:
            lib.tcpstore_server_stop(self._server)
            self._server = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class ReplicatedStore:
    """Registry store with master failover — the role of the reference's
    etcd-backed rendezvous (launch/controllers/master.py:175: elastic can
    point at an etcd cluster so losing one registry node doesn't kill the
    job). Semantics are scoped to the elastic REGISTRY contract, not full
    consensus:

    - writes (set/delete) fan out to every currently-reachable replica;
      compare_set decides on the first live replica and, on success,
      replicates the winning value to the others as a plain set;
    - reads (get/wait) serve from the first reachable replica in
      endpoint order, failing over past dead ones;
    - add() (barrier counters) goes to the first live replica only — it
      is not idempotent, so fan-out would double-count; a failover
      mid-barrier surfaces as the barrier's own timeout and retries
      cleanly;
    - a replica that errors is retired from both paths and RE-PROBED
      after `probe_interval` seconds — every client must converge to the
      same live set, or one client's transient socket error would freeze
      its heartbeats on a replica other clients still read (a node would
      look stale and be spuriously evicted).

    Best-effort replication is sufficient here because registry values
    are heartbeats re-written every interval: within one heartbeat
    period after a failover (or a replica's return) the serving replica
    converges to the true membership, which is exactly the staleness the
    elastic watcher already tolerates
    (tests/test_replicated_store.py kills the primary mid-run and
    membership tracking continues). This is NOT a general replicated KV:
    values that are written once and never refreshed can be lost on
    failover.
    """

    def __init__(self, endpoints, world_size: int = 1, timeout: float = 30.0,
                 probe_interval: float = 10.0):
        self._endpoints = _parse_endpoints(endpoints)
        if not self._endpoints:
            raise ValueError("ReplicatedStore needs at least one "
                             "host:port endpoint")
        self.world_size = world_size
        self.timeout = timeout
        self.probe_interval = float(probe_interval)
        self._clients = [None] * len(self._endpoints)
        # 0 = live; else monotonic time after which to re-probe
        self._retry_at = [0.0] * len(self._endpoints)

    def _client(self, i):
        if self._retry_at[i]:
            if time.monotonic() < self._retry_at[i]:
                return None
            self._retry_at[i] = 0.0  # probe window reached: try again
        if self._clients[i] is None:
            host, port = self._endpoints[i]
            try:
                # retry_attempts=1: the replica layer IS the retry —
                # mark-dead + failover + re-probe; client-level backoff
                # under it would stall every op that first touches a
                # dead replica
                self._clients[i] = TCPStore(host=host, port=port,
                                            world_size=self.world_size,
                                            timeout=self.timeout,
                                            retry_attempts=1)
            except Exception:  # noqa: BLE001  (conn refused et al.)
                self._mark_dead(i)
                return None
        return self._clients[i]

    def _mark_dead(self, i):
        self._retry_at[i] = time.monotonic() + self.probe_interval
        c, self._clients[i] = self._clients[i], None
        if c is not None:
            try:
                c.stop()
            except Exception:  # noqa: BLE001
                pass

    def _write_all(self, op):
        """Apply op to every reachable replica; at least one must ack."""
        ok = 0
        first_err = None
        for i in range(len(self._endpoints)):
            c = self._client(i)
            if c is None:
                continue
            try:
                op(c)
                ok += 1
            except Exception as e:  # noqa: BLE001
                self._mark_dead(i)
                first_err = first_err or e
        if ok == 0:
            raise RuntimeError(
                f"ReplicatedStore: every replica {self._endpoints} is "
                f"unreachable") from first_err
        return ok

    def _read_primary(self, op):
        """Serve from the first live replica in endpoint order.

        TimeoutError is NOT replica death: TCPStore.wait/barrier raise
        it when the key/count simply isn't there yet — the replica
        answered, on time, with "not yet". Retiring the healthy primary
        on it (and then the standby) would freeze writes for
        probe_interval and evict live nodes — the exact spurious-eviction
        scenario the class docstring warns about. It propagates so the
        caller's own rendezvous retry loop sees the timeout it asked for.
        """
        first_err = None
        for i in range(len(self._endpoints)):
            c = self._client(i)
            if c is None:
                continue
            try:
                return op(c)
            except TimeoutError:
                raise
            except Exception as e:  # noqa: BLE001
                self._mark_dead(i)
                first_err = first_err or e
        raise RuntimeError(
            f"ReplicatedStore: every replica {self._endpoints} is "
            f"unreachable") from first_err

    # --- the TCPStore surface the elastic/launch stack uses ---
    def set(self, key, value):
        self._write_all(lambda c: c.set(key, value))

    def delete_key(self, key):
        self._write_all(lambda c: c.delete_key(key))

    def get(self, key):
        return self._read_primary(lambda c: c.get(key))

    def wait(self, key, timeout=None):
        return self._read_primary(lambda c: c.wait(key, timeout))

    def compare_set(self, key, expected, desired):
        """CAS decided on the first live replica; a WIN replicates to the
        others as a plain set so a later failover still sees the claimed
        value (losing outcomes write nothing anywhere)."""
        out = self._read_primary(
            lambda c: c.compare_set(key, expected, desired))
        if out == (desired if isinstance(desired, bytes)
                   else str(desired).encode()):
            try:
                self._write_all(lambda c: c.set(key, desired))
            except RuntimeError:
                pass  # the deciding replica already has it
        return out

    def add(self, key, delta: int = 1):
        return self._read_primary(lambda c: c.add(key, delta))

    def barrier(self, name: str = "barrier", timeout=None):
        return self._read_primary(lambda c: c.barrier(name, timeout))

    def stop(self):
        for i in range(len(self._endpoints)):
            self._mark_dead(i)


# ---------------------------------------------------------------- quorum --
# Value envelope: QuorumStore tags every set/compare_set payload with the
# writer's believed epoch so a reader can RECOGNIZE a newer world (and a
# test can prove which epoch committed a value). add() counters stay raw
# (the server's ADD parses the stored value as an integer), so _unwrap
# passes any non-enveloped value through untouched.
_ENV_MAGIC = b"q1|"


def _wrap_value(epoch: int, v: bytes) -> bytes:
    return _ENV_MAGIC + str(int(epoch)).encode() + b"|" + v


def _unwrap_value(raw):
    """-> (epoch | None, value_bytes); non-envelope values pass through."""
    raw = raw or b""
    if raw.startswith(_ENV_MAGIC):
        head, sep, rest = raw[len(_ENV_MAGIC):].partition(b"|")
        if sep and head.isdigit():
            return int(head), rest
    return None, raw


def _parse_election(raw) -> Optional[dict]:
    import json as _json

    if not raw:
        return None
    try:
        rec = _json.loads(raw)
        return {"epoch": int(rec["epoch"]), "primary": str(rec["primary"])}
    except (ValueError, TypeError, KeyError):
        return None


@shared_state("_epoch", "_primary_i", "_validated_at", "_retry_at",
              "_needs_resync", "counters")
class QuorumStore:
    """HA control-plane store: N member TCPStores, one epoch-fenced
    primary, majority quorum — the registry survives losing its own
    host (the role of the reference's etcd-backed elastic rendezvous).

    Same surface as TCPStore/ReplicatedStore (set/get/compare_set/
    delete_key/wait/add/barrier + keys), so the elastic/fabric tiers
    mount it unmodified. Semantics:

    - ELECTION: the record ``__quorum/primary`` = ``{"epoch": E,
      "primary": "host:port"}`` lives on every member. A client that
      finds the primary dead (or no primary at all) proposes
      ``(max_seen_epoch + 1, first reachable member)`` by CAS on each
      reachable member's record; MAJORITY acks commit the election.
      Candidate choice is deterministic (endpoint order), so racing
      electors converge on the same proposal and count each other's
      CAS as their own ack.
    - FENCING: every validation/confirmation reads the election record
      from >= quorum members and adopts the max epoch. Any committed
      election lives on a majority, and two majorities intersect — so
      a client can never miss a committed election it is fenced by.
      Writes carry the writer's epoch in a value envelope; a read that
      surfaces a HIGHER epoch schedules immediate re-validation.
    - CAS ACROSS FAILOVER: compare_set decides on the primary (get ->
      unwrap -> raw CAS of envelopes), then CONFIRMS the epoch with a
      quorum read before reporting a win. If an election committed
      meanwhile, the decision may sit on a deposed primary: the win is
      discarded (``fence_rejections``), a compensating CAS restores
      the member's pre-decision value (resync is the fallback), and
      the CAS re-runs against the new epoch's primary. Confirmed wins
      replicate to every live member EPOCH-GUARDED (a member already
      holding a newer epoch's value keeps it), so the value survives
      the next primary death without a stale fan-out clobbering a
      newer committed CAS; the guard's read-then-set pair leaves a
      sub-ms non-atomic window on non-primary copies — within the
      registry's heartbeat-refresh staleness budget, not a general
      linearizable KV.
    - FAILOVER: a transport fault on the primary marks it dead,
      triggers an election and retries the op, all bounded by the op
      timeout. Fewer than quorum reachable members is a hard
      RuntimeError — a minority partition must not serve.
    - REJOIN-RESYNC: a member that returns (restarted empty, or
      partitioned with stale state) is re-probed after
      ``probe_interval`` and resynced BEFORE it rejoins the write
      fan-out: every current key is copied from the primary (raw, so
      envelopes survive byte-exact) and stale keys are deleted — an
      evicted host's corpse record cannot be resurrected by a
      returning member.

    Like ReplicatedStore, non-enveloped counters (``add``/barrier) are
    primary-local and not replicated: a failover mid-barrier surfaces
    as the barrier's own timeout and retries cleanly. Registry values
    are heartbeat-refreshed, which bounds post-failover staleness to
    one beat; this is still not a general replicated KV for
    write-once-never-refresh data.

    Thread-safe: `_lock` guards the election cache, member tables and
    counters (never held across a store op); `_elect_lock` serializes
    whole validations/elections/resyncs ACROSS threads — deliberately
    held across member network calls (bounded by member_timeout), the
    ``_beat_lock`` precedent: two concurrent electors in one process
    would double every probe and CAS for no extra safety.
    """

    ELECT_KEY = "__quorum/primary"

    def __init__(self, endpoints, world_size: int = 1,
                 timeout: float = 30.0, member_timeout: float = 1.5,
                 probe_interval: float = 2.0, epoch_ttl_s: float = 0.5):
        self._endpoints = _parse_endpoints(endpoints)
        if not self._endpoints:
            raise ValueError("QuorumStore needs at least one "
                             "host:port endpoint")
        self.world_size = world_size
        self.timeout = float(timeout)
        self.member_timeout = float(member_timeout)
        self.probe_interval = float(probe_interval)
        self.epoch_ttl_s = float(epoch_ttl_s)
        self.quorum = len(self._endpoints) // 2 + 1
        self._lock = threading.Lock()
        self._elect_lock = threading.Lock()
        self._clients = [None] * len(self._endpoints)
        # 0 = contactable; else monotonic time after which to re-probe
        self._retry_at = [0.0] * len(self._endpoints)
        # True once a member was marked dead: it must resync before it
        # rejoins the fan-out set (it may hold stale state, or none)
        self._needs_resync = [False] * len(self._endpoints)
        self._epoch = 0
        self._primary_i: Optional[int] = None
        # None = validation FORCED (never "fresh"). The sentinel must
        # not be 0.0: freshness is `monotonic() - _validated_at < ttl`,
        # and monotonic clocks start near zero on a fresh host, so a
        # zeroed stamp still read as fresh and a fence rejection looped
        # forever on the deposed epoch instead of re-validating.
        self._validated_at = None
        self._resync_thread: Optional[threading.Thread] = None
        self.counters = {"elections": 0, "failovers": 0,
                         "fence_rejections": 0, "resyncs": 0,
                         "quorum_reads": 0}

    # ------------------------------------------------------------ members --
    def _endpoint_str(self, i: int) -> str:
        host, port = self._endpoints[i]
        return f"{host}:{port}"

    def _member(self, i: int):
        """Connected client for member i, or None (dead / in its probe
        window). Connect happens outside the lock; a racing connect
        keeps the first winner."""
        with self._lock:
            if self._retry_at[i]:
                if time.monotonic() < self._retry_at[i]:
                    return None
                self._retry_at[i] = 0.0  # probe window reached
            c = self._clients[i]
        if c is not None:
            return c
        host, port = self._endpoints[i]
        try:
            # retry_attempts=1: THIS layer is the retry (mark-dead +
            # election + re-probe); stacked client backoff would stall
            # every op that first touches a dead member
            fresh = TCPStore(host=host, port=port,
                             world_size=self.world_size,
                             timeout=self.member_timeout,
                             retry_attempts=1)
        except Exception:  # noqa: BLE001 — conn refused et al.
            self._mark_dead(i)
            return None
        with self._lock:
            if self._retry_at[i]:
                # marked dead (or stop()'d) while we were connecting:
                # honor the verdict, don't install a zombie client
                c = None
            elif self._clients[i] is None:
                self._clients[i] = fresh
                return fresh
            else:
                c = self._clients[i]
        try:
            fresh.stop()
        except Exception:  # noqa: BLE001
            pass
        return c

    def _mark_dead(self, i: int) -> None:
        with self._lock:
            self._retry_at[i] = time.monotonic() + self.probe_interval
            self._needs_resync[i] = True
            c, self._clients[i] = self._clients[i], None
        if c is not None:
            try:
                c.stop()
            except Exception:  # noqa: BLE001
                pass

    # ----------------------------------------------------------- election --
    def _ensure(self):
        """-> (epoch, primary_index), validated within epoch_ttl_s
        (paths that must force re-validation set ``_validated_at`` to
        None — see __init__ for why the sentinel is not 0.0)."""
        with self._lock:
            if self._primary_i is not None and \
                    self._validated_at is not None and \
                    time.monotonic() - self._validated_at < \
                    self.epoch_ttl_s:
                return self._epoch, self._primary_i
        return self._validate()

    def _collect_votes(self):
        """Election-record snapshot from every contactable member:
        -> (votes: {i: record|None}, raws: {i: bytes})."""
        votes, raws = {}, {}
        for i in range(len(self._endpoints)):
            c = self._member(i)
            if c is None:
                continue
            try:
                raw = c.get(self.ELECT_KEY)
            except Exception:  # noqa: BLE001
                self._mark_dead(i)
                continue
            raws[i] = raw or b""
            votes[i] = _parse_election(raw)
        with self._lock:
            self.counters["quorum_reads"] += 1
        return votes, raws

    def _adopt(self, epoch: int, primary_i: int):
        with self._lock:
            self._epoch = int(epoch)
            self._primary_i = primary_i
            self._validated_at = time.monotonic()
        return self._epoch, primary_i

    def _validate(self):
        with self._elect_lock:
            # a racing thread may have just validated/elected
            with self._lock:
                if self._primary_i is not None and \
                        self._validated_at is not None and \
                        time.monotonic() - self._validated_at < \
                        self.epoch_ttl_s:
                    return self._epoch, self._primary_i
            votes, raws = self._collect_votes()
            if len(votes) < self.quorum:
                raise QuorumLostError(
                    f"QuorumStore: {len(votes)}/{len(self._endpoints)} "
                    f"members reachable — below quorum {self.quorum}")
            best = self._best_committed(votes)
            if best is not None:
                # a reachable member MISSING the election record others
                # hold was restarted empty (or wiped): flag it so it is
                # resynced and excluded from fan-out until then — and
                # never adopt/elect it while an informed member exists
                # (a fresh-empty primary would read as a mass graceful
                # leave to every front door)
                with self._lock:
                    for i in votes:
                        if votes[i] is None:
                            self._needs_resync[i] = True
                pi = self._primary_index(best["primary"])
                if pi is not None and votes.get(pi) is not None:
                    out = self._adopt(best["epoch"], pi)
                    self._resync_returners(votes, pi)
                    return out
            # no committed record, the recorded primary is unreachable,
            # or it holds no state (restarted empty): elect — which
            # commits a FRESH majority record superseding any orphan
            return self._elect(votes, raws)

    def _best_committed(self, votes) -> Optional[dict]:
        """The max-epoch election record held IDENTICALLY (epoch AND
        primary — split CAS rounds can leave two different records at
        the same epoch) by >= quorum members. An orphan record a
        crashed or out-voted elector left on a minority must NOT be
        adopted from its copies alone: a client that cannot see those
        members would follow a different primary, and two primaries
        would serve at once (the split-brain the majority-intersection
        fence exists to prevent). A committed record is on a majority
        by construction; re-election re-commits a legitimate record
        the member deaths have thinned below visibility."""
        counts: dict = {}
        for rec in votes.values():
            if rec:
                k = (rec["epoch"], rec["primary"])
                counts[k] = counts.get(k, 0) + 1
        committed = [k for k, n in counts.items() if n >= self.quorum]
        if not committed:
            return None
        epoch, primary = max(committed)  # ties broken deterministically
        return {"epoch": epoch, "primary": primary}

    def _primary_index(self, endpoint: str) -> Optional[int]:
        for i in range(len(self._endpoints)):
            if self._endpoint_str(i) == endpoint:
                return i
        return None

    def _elect(self, votes, raws):
        """Propose (max_epoch+1, first reachable member) via CAS on
        every reachable member; majority acks commit. Caller holds
        `_elect_lock`."""
        import json as _json

        for _attempt in range(8):
            # ONE max-epoch scan per attempt: the chaos hit, the
            # informed-member bias and the proposal must all see the
            # same epoch or they silently desynchronize
            max_e = max((r["epoch"] for r in votes.values() if r),
                        default=0)
            _chaos.hit("store.quorum_elect", epoch=max_e + 1)
            # deterministic: lowest live index, preferring INFORMED
            # members — ones holding the max-epoch election record and
            # not flagged for resync (a restarted-empty member must not
            # become primary while a state-bearing one exists). The
            # bias is client-local; racing electors with different
            # views still converge through the CAS.
            with self._lock:
                fresh = [i for i in votes if not self._needs_resync[i]]
            pool = fresh if fresh else list(votes)
            informed = [i for i in pool
                        if max_e == 0 or
                        (votes[i] and votes[i]["epoch"] == max_e)]
            candidate = min(informed) if informed else min(pool)
            proposal = {"epoch": max_e + 1,
                        "primary": self._endpoint_str(candidate)}
            desired = _json.dumps(proposal, sort_keys=True)
            acks = set()
            for i in list(votes):
                c = self._member(i)
                if c is None:
                    votes.pop(i, None)  # died since the vote read
                    continue
                try:
                    out = c.compare_set(
                        self.ELECT_KEY, raws.get(i, b"").decode(),
                        desired)
                except Exception:  # noqa: BLE001
                    self._mark_dead(i)
                    votes.pop(i, None)
                    continue
                if out == desired.encode():
                    acks.add(i)  # ours, or a racing elector's identical
                    raws[i] = out
                    votes[i] = dict(proposal)
                else:
                    raws[i] = out
                    votes[i] = _parse_election(out)
            # adoption needs a majority AND the candidate's own ack —
            # a candidate that died between the vote read and the CAS
            # must not be published as a majority record naming a dead
            # primary (every client would burn an extra election)
            if len(acks) >= self.quorum and candidate in acks:
                with self._lock:
                    self.counters["elections"] += 1
                out = self._adopt(proposal["epoch"], candidate)
                self._resync_returners(votes, candidate)
                return out
            # lost: adopt the farthest-ahead MAJORITY-COMMITTED record
            # (same rule as _validate — a single-copy orphan is not a
            # verdict) if its primary is reachable AND holds its own
            # record (an empty restarted member must not be adopted),
            # else re-propose
            best = self._best_committed(votes)
            if best is not None:
                pi = self._primary_index(best["primary"])
                if pi is not None and votes.get(pi) is not None:
                    out = self._adopt(best["epoch"], pi)
                    self._resync_returners(votes, pi)
                    return out
            if len(votes) < self.quorum:
                raise QuorumLostError(
                    f"QuorumStore: quorum lost mid-election "
                    f"({len(votes)}/{len(self._endpoints)} reachable)")
            time.sleep(0.02)
        raise RuntimeError("QuorumStore: election did not converge")

    # ------------------------------------------------------------- resync --
    def _resync_returners(self, votes, primary_i: int) -> None:
        """Hand every reachable member flagged by a past mark-dead
        (restarted empty, or stale after a partition) to the resync
        worker. The COPYING runs on its own daemon thread, never under
        `_elect_lock`: a resync is O(keys) member round-trips, and
        holding the election lock across it would stall every op on
        this client (heartbeats included — leases would falsely expire,
        the exact failure this store exists to prevent). Until its copy
        completes a flagged member stays excluded from fan-out and from
        candidate preference, so the deferral is safe."""
        with self._lock:
            pending = [i for i in votes
                       if self._needs_resync[i] and i != primary_i]
            if self._needs_resync[primary_i]:
                # the primary itself cannot resync from anyone better-
                # informed; adopting it IS the authority hand-off
                self._needs_resync[primary_i] = False
            if not pending:
                return
            if self._resync_thread is not None and \
                    self._resync_thread.is_alive():
                return  # one worker at a time; next validation retries
            t = threading.Thread(
                target=self._resync_worker, args=(pending, primary_i),
                name="quorum-resync", daemon=True)
            self._resync_thread = t
        t.start()

    def _resync_worker(self, pending, primary_i: int) -> None:
        for i in pending:
            src = self._member(primary_i)
            dst = self._member(i)
            if src is None or dst is None:
                continue
            try:
                current = src.keys()
                stale = dst.keys()
                for k in current:
                    dst.set(k, src.get(k))  # raw: envelopes byte-exact
                for k in set(stale) - set(current):
                    dst.delete_key(k)
            except Exception:  # noqa: BLE001 — flapped mid-resync:
                self._mark_dead(i)   # flag stays set, next probe
                continue             # window retries
            with self._lock:
                self._needs_resync[i] = False
                self.counters["resyncs"] += 1

    # ------------------------------------------------------------ fencing --
    def _confirm_epoch(self, epoch: int, primary_ep: str) -> bool:
        """Quorum read of the election record: True iff OUR exact
        record — epoch AND primary — is held by a majority right now.
        Epoch alone is not enough: a split CAS round can leave two
        records at the same epoch naming different primaries, and a
        client on the minority record would otherwise confirm its CAS
        wins against a primary the majority never agreed on. Majority
        intersection makes a committed newer/conflicting election
        impossible to miss."""
        votes, _ = self._collect_votes()
        if len(votes) < self.quorum:
            raise QuorumLostError(
                f"QuorumStore: cannot confirm epoch {epoch} — "
                f"{len(votes)} members reachable, quorum {self.quorum}")
        mine = sum(1 for r in votes.values()
                   if r and r["epoch"] == epoch and
                   r["primary"] == primary_ep)
        if mine < self.quorum:
            with self._lock:
                self.counters["fence_rejections"] += 1
                self._validated_at = None  # force re-validation
            return False
        return True

    def _failover(self, primary_i: int) -> None:
        self._mark_dead(primary_i)
        with self._lock:
            self.counters["failovers"] += 1
            self._primary_i = None
            self._validated_at = None

    def _fan_out(self, op, skip: int) -> None:
        """Best-effort replication of a committed write to every other
        live member (resynced members only — see _needs_resync)."""
        for i in range(len(self._endpoints)):
            if i == skip:
                continue
            with self._lock:
                if self._needs_resync[i]:
                    continue  # must resync before taking writes again
            c = self._member(i)
            if c is None:
                continue
            try:
                op(c)
            except Exception:  # noqa: BLE001
                self._mark_dead(i)

    def _fan_out_guarded(self, key: str, env: bytes, epoch: int,
                         skip: int) -> None:
        """CAS-win replication with an epoch guard: a member already
        holding a HIGHER-epoch envelope for the key keeps it — our
        (older-epoch) win must not clobber a newer epoch's committed
        CAS that raced ahead of this fan-out. The read-then-set pair
        is not atomic, so a sub-ms interleave can still invert two
        near-simultaneous cross-epoch writes on one member; the
        primary copy (where CAS decides) is never affected, and the
        registry's heartbeat-refresh contract bounds the exposure."""
        for i in range(len(self._endpoints)):
            if i == skip:
                continue
            with self._lock:
                if self._needs_resync[i]:
                    continue
            c = self._member(i)
            if c is None:
                continue
            try:
                cur_e, _ = _unwrap_value(c.get(key))
                if cur_e is not None and cur_e > epoch:
                    continue
                c.set(key, env)
            except Exception:  # noqa: BLE001
                self._mark_dead(i)

    def _on_primary(self, op_name: str, op, deadline: float = None):
        """Run `op(client, epoch)` on the validated primary, failing
        over past primary deaths until the op deadline. Only
        TRANSPORT-SHAPED errors (OSError/RuntimeError — what the
        TCPStore client raises for dead sockets/servers) trigger a
        failover: a caller bug (TypeError, UnicodeDecodeError...)
        must propagate, not mark healthy members dead one by one.
        TimeoutError is semantic ("not yet") and propagates untouched."""
        if deadline is None:
            deadline = time.monotonic() + self.timeout
        last_err = None
        while True:
            epoch, pi = self._ensure()
            c = self._member(pi)
            if c is not None:
                try:
                    return op(c, epoch, pi)
                except TimeoutError:
                    raise
                except QuorumLostError:
                    raise  # a system-wide verdict, not THIS member's
                except (OSError, RuntimeError) as e:
                    last_err = e
                    self._failover(pi)
            else:
                self._failover(pi)
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    f"QuorumStore: {op_name} failed within the "
                    f"{self.timeout}s op timeout") from last_err

    # --------------------------------------------- the TCPStore surface --
    def set(self, key, value):
        v = value if isinstance(value, bytes) else str(value).encode()

        def op(c, epoch, pi):
            env = _wrap_value(epoch, v)
            c.set(key, env)
            self._fan_out(lambda m: m.set(key, env), skip=pi)

        self._on_primary("set", op)

    def get(self, key) -> bytes:
        def op(c, epoch, pi):
            e, val = _unwrap_value(c.get(key))
            if e is not None and e > epoch:
                with self._lock:  # a newer world wrote this: re-validate
                    self._validated_at = None
            return val

        return self._on_primary("get", op)

    def delete_key(self, key):
        def op(c, epoch, pi):
            c.delete_key(key)
            self._fan_out(lambda m: m.delete_key(key), skip=pi)

        self._on_primary("delete", op)

    def keys(self, prefix: str = "") -> list:
        return self._on_primary(
            "keys", lambda c, epoch, pi: c.keys(prefix))

    def add(self, key, delta: int = 1) -> int:
        # non-idempotent: no replay, no fan-out (counters are primary-
        # local; a failover mid-barrier is the barrier's own timeout)
        return self._on_primary(
            "add", lambda c, epoch, pi: c.add(key, delta))

    def compare_set(self, key, expected, desired) -> bytes:
        """CAS with the epoch fence: decide on the primary, confirm the
        epoch with a quorum read, only then report (and replicate) the
        win. A fence rejection re-runs the CAS against the new epoch's
        primary — the deposed member's phantom write is dead state that
        the next resync clobbers."""
        exp_b = expected if isinstance(expected, bytes) \
            else str(expected).encode()
        try:
            # str() for non-bytes, mirroring `expected` — bytes(int)
            # would build a NUL-filled buffer, not the digits
            des_s = desired.decode() if isinstance(desired, bytes) \
                else str(desired)
        except UnicodeDecodeError:
            raise TypeError(
                "QuorumStore.compare_set takes UTF-8 text values (the "
                "member CAS protocol is text); use set() for binary "
                "payloads") from None
        deadline = time.monotonic() + self.timeout
        while True:
            def op(c, epoch, pi):
                raw = c.get(key)
                _, cur = _unwrap_value(raw)
                if cur != exp_b:
                    return ("lost", cur)
                env = _wrap_value(epoch, des_s.encode())
                try:
                    raw_s = (raw or b"").decode()
                except UnicodeDecodeError:
                    raise TypeError(
                        f"QuorumStore.compare_set: current value at "
                        f"{key!r} is not UTF-8 text — CAS over binary "
                        f"values is unsupported") from None
                out = c.compare_set(key, raw_s, env.decode())
                if out != env:
                    return ("lost", _unwrap_value(out)[1])
                if not self._confirm_epoch(epoch,
                                           self._endpoint_str(pi)):
                    # compensating undo: our phantom sits on a deposed
                    # primary this client may never talk to again —
                    # CAS it straight back to the pre-decision value
                    # (a no-op if a newer write already landed), so
                    # cleanup doesn't depend on some OTHER client
                    # living long enough to resync this member
                    try:
                        undone = c.compare_set(key, env.decode(),
                                               raw_s)
                        if not raw_s and undone == b"":
                            # the key did not EXIST before our CAS:
                            # restoring "" would leave an empty-but-
                            # present key that releases wait()ers
                            # (EXISTS_GET presence contract) — delete
                            # to truly put it back
                            c.delete_key(key)
                    except Exception:  # noqa: BLE001 — resync and the
                        pass  # next refresh remain the fallback
                    return ("fenced", None)
                self._fan_out_guarded(key, env, epoch, skip=pi)
                return ("won", des_s.encode())

            verdict, val = self._on_primary("compare_set", op,
                                            deadline=deadline)
            if verdict != "fenced":
                return val
            # fenced: loop re-validates and retries on the new primary
            if time.monotonic() >= deadline:
                raise RuntimeError(
                    "QuorumStore: compare_set fenced past the op "
                    "timeout (elections kept landing mid-decision)")

    def wait(self, key, timeout=None) -> bytes:
        """Deadline-bounded wait, re-validating between short chunks so
        a mid-wait failover keeps the wait alive on the new primary."""
        deadline = time.monotonic() + (timeout or self.timeout)
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"wait({key!r}) timed out")

            def op(c, epoch, pi):
                return c.wait(key, min(0.25, max(0.01, remaining)))

            try:
                return _unwrap_value(
                    self._on_primary("wait", op, deadline=deadline))[1]
            except TimeoutError:
                continue  # chunk expired: re-validate, keep waiting

    def barrier(self, name: str = "barrier", timeout=None):
        """All world_size participants arrive, then proceed (same
        arithmetic as TCPStore.barrier, over the fenced ops)."""
        n = self.add(f"__{name}_cnt", 1)
        gen = (n - 1) // self.world_size
        target = (gen + 1) * self.world_size
        deadline = time.monotonic() + (timeout or self.timeout)
        while time.monotonic() < deadline:
            if int(self.get(f"__{name}_cnt") or b"0") >= target:
                return
            time.sleep(0.01)
        raise TimeoutError(f"barrier {name} timed out ({n}/{target})")

    def counters_snapshot(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def stop(self):
        for i in range(len(self._endpoints)):
            with self._lock:
                c, self._clients[i] = self._clients[i], None
                self._retry_at[i] = float("inf")
            if c is not None:
                try:
                    c.stop()
                except Exception:  # noqa: BLE001
                    pass


def make_store(spec, timeout: float = 30.0, **kw):
    """Store client from an endpoint spec: ``"host:port"`` connects a
    plain TCPStore client; ``"h1:p1,h2:p2,h3:p3"`` (or a list) mounts a
    :class:`QuorumStore` over the members — the FABRIC_STORE /
    --store_endpoints contract, one line for both worlds."""
    parts = _parse_endpoints(spec)
    if not parts:
        raise ValueError("empty store endpoint spec")
    if len(parts) == 1:
        host, port = parts[0]
        return TCPStore(host, port, timeout=timeout, **kw)
    return QuorumStore(parts, timeout=timeout, **kw)


_GLOBAL_PY_STORE = _PyFallbackStore()


# ---------------------------------------------------------- JSON indexes --
# A membership registry needs one LIST key ("who is registered") next to
# the per-member record keys. Read-modify-write on that list loses
# updates when two members join at once, so these helpers route through
# compare_set when the store has it (TCPStore / ReplicatedStore) and
# fall back to plain get/set for dict-like fakes. Shared by
# distributed.elastic (trainer membership) and inference.fabric
# (serving-host membership).
def _index_cas(store, key: str, mutate, retries: int = 32) -> list:
    import json as _json

    for _ in range(retries):
        raw = store.get(key) or b""
        cur = sorted(set(_json.loads(raw or b"[]")))
        new = mutate(list(cur))
        if new == cur:
            return cur
        desired = _json.dumps(new)
        cas = getattr(store, "compare_set", None)
        if cas is None:
            store.set(key, desired)
            return new
        won = cas(key, raw.decode() if raw else "", desired)
        if won == desired.encode():
            return new
    raise RuntimeError(f"index update on {key!r} lost {retries} CAS races")


def index_add(store, key: str, member: str) -> list:
    """Add `member` to the JSON list at `key` (CAS loop; lost-update
    safe). Returns the resulting membership."""
    def mutate(ids):
        if member not in ids:
            ids.append(member)
        return sorted(ids)

    return _index_cas(store, key, mutate)


def index_discard(store, key: str, member: str) -> list:
    """Remove `member` from the JSON list at `key`; returns the
    resulting membership."""
    def mutate(ids):
        return sorted(i for i in ids if i != member)

    return _index_cas(store, key, mutate)


def index_members(store, key: str) -> list:
    import json as _json

    return sorted(set(_json.loads(store.get(key) or b"[]")))
