"""Serving-tier actuators: ReplicaAutoscaler + HealthWatchdog
(counterpart of paddle_tpu/autoscale/replica.py).

The closed loop of elastic serving: the serving metrics that used to be
a dashboard (queue depth, p95, occupancy)
become the INPUT of a controller that grows and shrinks the engine's
replica pool at runtime, and a health watchdog that replaces wedged
replicas instead of waiting for a human.

Degrade order under overload is scale -> queue -> shed: the autoscaler
publishes its remaining headroom into the engine
(``engine.scale_headroom_fn``), and the engine's circuit breaker
stretches its queue bound while headroom remains — requests are shed
only after the pool is maxed out AND the stretched queue is full.

Both controllers are plain daemon threads over public engine APIs
(add_replica / remove_replica / revive_replica / replica_states), so a
deployment can also drive the same APIs from an external operator.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Optional

from .policy import ScalingPolicy

_LOG = logging.getLogger("paddle_tpu_torch.autoscale")


class ReplicaAutoscaler:
    """Poll the engine's metrics, decide with a ScalingPolicy, actuate.

    Scale-up warms the new replica (every program once) BEFORE it
    is admitted (engine.add_replica contract) — on this controller
    thread, so the serving pool never stalls on a warmup. Scale-down is
    always drain-then-retire: zero in-flight requests lost.
    """

    def __init__(self, engine, policy: Optional[ScalingPolicy] = None,
                 poll_interval_s: float = 0.25):
        if policy is None:
            policy = ScalingPolicy(
                min_replicas=1,
                max_replicas=max(2, len(engine._device_pool)))
        self.engine = engine
        self.policy = policy
        self.poll_interval_s = float(poll_interval_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.counters = {"scale_ups": 0, "scale_downs": 0,
                         "scale_errors": 0}
        self.events: "deque[dict]" = deque(maxlen=256)
        # breaker integration: while we still have room to grow, the
        # engine queues instead of shedding
        engine.scale_headroom_fn = self._headroom
        from . import _track
        _track(self)

    # ----------------------------------------------------------- signals --
    def _headroom(self) -> int:
        return self.policy.headroom(len(self.engine._active()))

    def _signals(self) -> dict:
        eng = self.engine
        states = eng.replica_states()
        live = [s for s in states if s["state"] == "active"]
        return {
            "replicas": len(live),
            "busy_replicas": sum(1 for s in live if s["busy_s"] > 0),
            # race: allow approximate scaling signal — GIL-atomic len
            "queue_depth": len(eng._queue),
            "p95_ms": eng.metrics.latency_percentiles()["p95"] * 1e3,
            # context only (the policy ignores it): lets an event log
            # prove shedding had/hadn't begun when a decision fired
            # race: allow approximate event-log context — atomic int
            "shed_total": eng.metrics.shed_total,
        }

    # ---------------------------------------------------------- lifecycle --
    def start(self) -> "ReplicaAutoscaler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="autoscale-replicas", daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        # unhook the breaker integration: a dead controller must not
        # keep stretching the queue bound toward a scale-up that will
        # never come (and the bound method would pin us alive)
        if self.engine.scale_headroom_fn == self._headroom:
            self.engine.scale_headroom_fn = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the controller must
                # outlive any single sick poll; errors are counted and
                # the next poll retries
                self.counters["scale_errors"] += 1
                _LOG.warning("autoscaler poll failed: %r", e)

    # ----------------------------------------------------------- control --
    def poll_once(self, now: Optional[float] = None) -> int:
        """One observe/decide/actuate cycle; returns the applied delta.
        Public for tests and for external drivers that own the clock."""
        if now is None:
            now = time.monotonic()
        sig = self._signals()
        delta = self.policy.observe(now, sig)
        if delta > 0:
            report = self.engine.add_replica()
            self.counters["scale_ups"] += 1
            self.events.append({"action": "scale_up", "rid": report["rid"],
                                "signals": sig,
                                "warmed": report["warmed_executables"]})
        elif delta < 0:
            report = self.engine.remove_replica(drain=True)
            self.counters["scale_downs"] += 1
            self.events.append({"action": "scale_down",
                                "rid": report["rid"], "signals": sig,
                                "drained": report["drained"]})
        return delta


class HealthWatchdog:
    """Detect and replace hung replicas.

    Two independent liveness signals per replica, both on the MONOTONIC
    clock (a wall-clock jump must never mass-retire a healthy pool):

    - ``busy_s``: time inside the current device batch. Beyond
      ``exec_deadline_s`` the worker is presumed wedged mid-execute
      (the chaos `serving.execute:delay` site injects exactly this).
    - ``beat_age_s``: time since the worker loop last reached its top.
      Beyond ``beat_deadline_s`` the thread is dead or deadlocked even
      though no batch is marked in flight.

    Response ladder (bounded, per replica, with backoff between
    strikes): first ``max_revives`` strikes revive in place
    (engine.revive_replica — fresh worker generation, in-flight batch
    requeued to healthy replicas); after that the replica is presumed
    device-sick and is retired without drain + replaced by a fresh
    replica on the least-loaded device.
    """

    def __init__(self, engine, exec_deadline_s: float = 5.0,
                 beat_deadline_s: float = 10.0,
                 poll_interval_s: float = 0.25,
                 max_revives: int = 2, backoff_s: float = 1.0,
                 strike_reset_s: float = 60.0):
        self.engine = engine
        self.exec_deadline_s = float(exec_deadline_s)
        self.beat_deadline_s = float(beat_deadline_s)
        self.poll_interval_s = float(poll_interval_s)
        self.max_revives = int(max_revives)
        self.backoff_s = float(backoff_s)
        self.strike_reset_s = float(strike_reset_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._strikes: dict = {}       # rid -> strike count
        self._last_strike_t: dict = {}  # rid -> monotonic time
        self.counters = {"watchdog_revives": 0, "watchdog_replacements": 0,
                         "watchdog_errors": 0}
        self.events: "deque[dict]" = deque(maxlen=256)
        from . import _track
        _track(self)

    # ---------------------------------------------------------- lifecycle --
    def start(self) -> "HealthWatchdog":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="autoscale-watchdog", daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — watchdog outlives
                self.counters["watchdog_errors"] += 1
                _LOG.warning("watchdog poll failed: %r", e)

    # ------------------------------------------------------------- check --
    def _other_device(self, sick_device: str):
        """Least-loaded pool device that is NOT the sick one (by the
        engine's replica placement); None on a single-device pool."""
        counts: dict = {}
        for r in self.engine.replica_states():
            if r["state"] in ("warming", "active", "draining"):
                counts[r["device"]] = counts.get(r["device"], 0) + 1
        others = [d for d in self.engine._device_pool
                  if str(d) != sick_device]
        if not others:
            return None
        return min(others, key=lambda d: counts.get(str(d), 0))

    def _hung(self, row: dict) -> Optional[str]:
        if row.get("compiling"):
            # a first-compile of an executable (warmup-skipped engines
            # hit this on every cold bucket) legitimately blocks the
            # worker for tens of seconds — not a hang; striking would
            # start a revive/recompile storm and burn the request's
            # one requeue on an innocent replica
            return None
        if row["busy_s"] > self.exec_deadline_s:
            return f"execute exceeded {self.exec_deadline_s}s deadline"
        if row["beat_age_s"] > self.beat_deadline_s:
            return f"heartbeat stale {row['beat_age_s']:.1f}s"
        return None

    def poll_once(self, now: Optional[float] = None) -> int:
        """Inspect every live replica once; returns the number of
        actions taken. Public for tests."""
        if now is None:
            now = time.monotonic()
        actions = 0
        rows = self.engine.replica_states()
        # bookkeeping hygiene on a long-lived server: strikes on a
        # replica that has been healthy for strike_reset_s are forgiven
        # (transient hiccups weeks apart must not accumulate into a
        # replacement), and entries for replicas no longer live are
        # dropped
        live = {r["rid"] for r in rows
                if r["state"] in ("active", "draining")}
        for rid in list(self._strikes):
            last = self._last_strike_t.get(rid)
            if rid not in live or (last is not None
                                   and now - last > self.strike_reset_s):
                self._strikes.pop(rid, None)
                self._last_strike_t.pop(rid, None)
        for row in rows:
            if row["state"] not in ("active", "draining"):
                continue
            reason = self._hung(row)
            if reason is None:
                continue
            rid = row["rid"]
            last = self._last_strike_t.get(rid)
            if last is not None and now - last < self.backoff_s:
                continue  # give the previous action time to land
            self._last_strike_t[rid] = now
            strikes = self._strikes.get(rid, 0) + 1
            self._strikes[rid] = strikes
            try:
                if strikes <= self.max_revives:
                    self.engine.revive_replica(rid)
                    self.counters["watchdog_revives"] += 1
                    self.events.append({"action": "revive", "rid": rid,
                                        "reason": reason,
                                        "strike": strikes})
                else:
                    # the device itself is presumed sick: the
                    # replacement must land on a DIFFERENT device —
                    # add_replica's synchronous warmup on the wedged
                    # device would block this watchdog thread forever.
                    # No other device (single-device pool): revive in
                    # place instead; a fresh worker is all we have.
                    dev = self._other_device(row["device"])
                    if dev is None:
                        self.engine.revive_replica(rid)
                        self.counters["watchdog_revives"] += 1
                        self.events.append({"action": "revive",
                                            "rid": rid,
                                            "reason": reason,
                                            "strike": strikes})
                        actions += 1
                        continue
                    # add the replacement FIRST (keeps capacity, and a
                    # 1-replica pool would otherwise refuse to drop its
                    # last active member), then retire without drain —
                    # its queued/in-flight work is requeued
                    report = self.engine.add_replica(device=dev)
                    self.engine.remove_replica(rid, drain=False)
                    self.counters["watchdog_replacements"] += 1
                    self.events.append({"action": "replace", "rid": rid,
                                        "new_rid": report["rid"],
                                        "reason": reason})
                actions += 1
            except ValueError:
                # replica vanished between snapshot and action (e.g. a
                # concurrent scale-down took it) — nothing to do
                self._strikes.pop(rid, None)
        return actions


__all__ = ["ReplicaAutoscaler", "HealthWatchdog"]
