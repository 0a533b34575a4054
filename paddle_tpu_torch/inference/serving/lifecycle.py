"""Serving-tier lifecycle primitives (counterpart of
paddle_tpu/inference/serving/lifecycle.py).

Both engines, the predict engine (engine.py) and the generation engine
(generate.py), run the reference's replica state machine (warming ->
active -> draining -> retired, with a generation counter that supersedes
a hung worker) and complete requests through a first-set-wins Future;
errors carry HTTP statuses. `device_pool` is the port's own: the devices
a replica may be placed on.
"""
from __future__ import annotations

import threading
import time
from queue import Queue
from typing import List, Optional

import torch

from ...testing.racecheck import shared_state as _shared_state


class ServingError(Exception):
    """Engine-level request failure; `status` follows HTTP semantics
    (400 decode/shape, 503 shed/deadline/shutdown, 500 runtime)."""

    def __init__(self, status: int, message: str,
                 retry_after: Optional[float] = None):
        super().__init__(message)
        self.status = int(status)
        self.message = message
        self.retry_after = retry_after


class Future:
    """Completion handle for one submitted request.

    Completion is idempotent — the FIRST set wins. revive_replica may
    requeue a hung replica's batch onto a healthy one; if the zombie
    thread later unwedges and reports too, its late completion must not
    clobber the result a client already consumed.
    """

    def __init__(self):
        self._ev = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._error: Optional[BaseException] = None

    def set_result(self, result) -> bool:
        with self._lock:
            if self._ev.is_set():
                return False
            self._result = result
            self._ev.set()
            return True

    def set_error(self, err: BaseException) -> bool:
        with self._lock:
            if self._ev.is_set():
                return False
            self._error = err
            self._ev.set()
            return True

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("serving request timed out")
        if self._error is not None:
            raise self._error
        return self._result


@_shared_state("state", "generation", "thread", "last_beat",
               "busy_since", "inflight", "batches", "compiling")
class ReplicaSlot:
    """One worker replica: a device binding, a worker thread and (for the
    predict engine) a dispatch queue of batches. `state` lifecycle:
    warming -> active -> draining -> retired. `generation` supersedes a
    hung worker: the loop exits as soon as it observes a newer generation
    (revive_replica).

    The lifecycle fields are shared state (testing/racecheck): worker
    threads and the engine's callers touch them, and the owning
    engine's condition variable is their one guard."""

    __slots__ = ("rid", "device", "q", "thread", "state", "generation",
                 "last_beat", "busy_since", "inflight", "batches",
                 "compiling")

    def __init__(self, rid: int, device, queue_depth: int = 2):
        self.rid = rid
        self.device = device
        self.q: Queue = Queue(maxsize=queue_depth)
        self.thread: Optional[threading.Thread] = None
        self.state = "warming"
        self.generation = 0
        self.last_beat = time.monotonic()
        self.busy_since: Optional[float] = None
        self.inflight: List = []
        self.batches = 0
        # True while the predict engine runs a batch whose shape the
        # warm-up did not run on this device (its first call)
        self.compiling = False

    def state_row(self, now: Optional[float] = None) -> dict:
        """One row of replica_states() with monotonic ages (the
        autoscale HealthWatchdog reads busy_s and beat_age_s to strike a
        hung worker)."""
        if now is None:
            now = time.monotonic()
        busy = self.busy_since
        return {
            "rid": self.rid,
            "state": self.state,
            "generation": self.generation,
            "device": str(self.device),
            "beat_age_s": now - self.last_beat,
            "busy_s": (now - busy) if busy is not None else 0.0,
            "inflight": len(self.inflight),
            "batches": self.batches,
            "compiling": self.compiling,
        }


def validate_sampling(obj) -> dict:
    """Request-side validation of the generation sampling fields: a
    malformed request 400s before it can take a KV slot.

    Rules: ``temperature`` is a number >= 0, ``top_k`` an int >= 1,
    ``top_p`` in (0, 1], ``seed`` an integer. Returns the four fields
    (None where absent); raises ServingError(400) on violation."""
    out = {}
    t = obj.get("temperature")
    if t is not None:
        if isinstance(t, bool) or not isinstance(t, (int, float)) or \
                not (float(t) >= 0.0):
            raise ServingError(
                400, f"temperature must be a number >= 0 (got {t!r})")
        t = float(t)
    out["temperature"] = t
    k = obj.get("top_k")
    if k is not None:
        if isinstance(k, bool) or not isinstance(k, int) or k < 1:
            raise ServingError(
                400, f"top_k must be an integer >= 1 (got {k!r})")
        k = int(k)
    out["top_k"] = k
    p = obj.get("top_p")
    if p is not None:
        if isinstance(p, bool) or not isinstance(p, (int, float)) or \
                not (0.0 < float(p) <= 1.0):
            raise ServingError(
                400, f"top_p must be in (0, 1] (got {p!r})")
        p = float(p)
    out["top_p"] = p
    s = obj.get("seed")
    if s is not None:
        if isinstance(s, bool) or not isinstance(s, int):
            raise ServingError(
                400, f"seed must be an integer (got {s!r})")
        s = int(s)
    out["seed"] = s
    return out


def pick_least_loaded_device(device_pool, replicas) -> object:
    """Least-loaded device in the pool by live-replica count (replicas
    on one device contend for it). Devices are counted by name: unlike
    the reference's JAX devices, two torch.device objects may name one
    card."""
    counts = {str(d): 0 for d in device_pool}
    for rep in replicas:
        if rep.state in ("warming", "active", "draining"):
            key = str(rep.device)
            counts[key] = counts.get(key, 0) + 1
    return min(device_pool, key=lambda d: counts[str(d)])


def device_pool(device) -> List[torch.device]:
    """The devices replicas may use: `device` itself when it names one
    (the CPU, or one card by index), every card when it is a bare
    "cuda"."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


__all__ = ["ServingError", "Future", "ReplicaSlot", "device_pool",
           "pick_least_loaded_device", "validate_sampling"]
