"""Scaling decision logic: hysteresis + cooldown over load signals
(counterpart of paddle_tpu/autoscale/policy.py).

Pure and clock-explicit (`now` is an argument) so every branch is
unit-testable without threads or sleeps. The policy never actuates —
it returns a delta (+1 / 0 / -1) and the ReplicaAutoscaler applies it.

Hysteresis is structural, not a single threshold pair:

- up and down use DIFFERENT signals (up: backlog/latency pressure;
  down: empty queue AND idle replicas), so the system cannot oscillate
  on one noisy series;
- each direction needs `*_consecutive` agreeing polls before it fires
  (a one-poll spike never scales);
- each direction has its own cooldown measured from the LAST scale
  action in either direction (a scale-up is given time to absorb load
  before a scale-down may even be considered, and vice versa).
"""
from __future__ import annotations

from typing import Optional


class ScalingPolicy:
    """Replica-count policy for the serving tier.

    Signals consumed per observation (a plain dict):

      replicas        active replica count
      queue_depth     engine request-queue depth
      busy_replicas   replicas currently executing a batch
      p95_ms          recent p95 latency (0 disables the latency trip)

    Scale-up when backlog exceeds ``up_queue_per_replica`` queued
    requests per active replica (or p95 exceeds ``up_p95_ms``, if set)
    for ``up_consecutive`` polls, outside the cooldown, below
    ``max_replicas``. Scale-down when the queue is at/below
    ``down_queue_per_replica`` per replica AND at most
    ``down_busy_frac`` of replicas are executing, for
    ``down_consecutive`` polls, outside the cooldown, above
    ``min_replicas``.
    """

    def __init__(self, min_replicas: int = 1,
                 max_replicas: Optional[int] = None,
                 up_queue_per_replica: float = 4.0,
                 up_p95_ms: float = 0.0,
                 down_queue_per_replica: float = 0.0,
                 down_busy_frac: float = 0.34,
                 up_consecutive: int = 2,
                 down_consecutive: int = 8,
                 up_cooldown_s: float = 1.0,
                 down_cooldown_s: float = 5.0):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas is not None and max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas) if max_replicas else None
        self.up_queue_per_replica = float(up_queue_per_replica)
        self.up_p95_ms = float(up_p95_ms)
        self.down_queue_per_replica = float(down_queue_per_replica)
        self.down_busy_frac = float(down_busy_frac)
        self.up_consecutive = max(1, int(up_consecutive))
        self.down_consecutive = max(1, int(down_consecutive))
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self._up_hits = 0
        self._down_hits = 0
        self._last_action_t: Optional[float] = None

    # ------------------------------------------------------------ deciding --
    def headroom(self, replicas: int) -> int:
        """Scale-up room left (engine breaker consults this: while > 0
        the queue stretches instead of shedding)."""
        if self.max_replicas is None:
            return 1
        return max(0, self.max_replicas - int(replicas))

    def _overloaded(self, s: dict) -> bool:
        reps = max(1, int(s.get("replicas", 1)))
        if float(s.get("queue_depth", 0)) > \
                self.up_queue_per_replica * reps:
            return True
        return self.up_p95_ms > 0 and \
            float(s.get("p95_ms", 0.0)) > self.up_p95_ms

    def _idle(self, s: dict) -> bool:
        reps = max(1, int(s.get("replicas", 1)))
        if float(s.get("queue_depth", 0)) > \
                self.down_queue_per_replica * reps:
            return False
        return float(s.get("busy_replicas", 0)) <= \
            self.down_busy_frac * reps

    def observe(self, now: float, signals: dict) -> int:
        """Record one poll; returns the replica delta to apply
        (+1, -1 or 0)."""
        reps = int(signals.get("replicas", 1))
        if self._overloaded(signals):
            self._up_hits += 1
            self._down_hits = 0
        elif self._idle(signals):
            self._down_hits += 1
            self._up_hits = 0
        else:
            self._up_hits = 0
            self._down_hits = 0
        since = None if self._last_action_t is None \
            else now - self._last_action_t
        if self._up_hits >= self.up_consecutive and \
                (since is None or since >= self.up_cooldown_s) and \
                (self.max_replicas is None or reps < self.max_replicas):
            self._up_hits = 0
            self._last_action_t = now
            return 1
        if self._down_hits >= self.down_consecutive and \
                (since is None or since >= self.down_cooldown_s) and \
                reps > self.min_replicas:
            self._down_hits = 0
            self._last_action_t = now
            return -1
        return 0


__all__ = ["ScalingPolicy"]
