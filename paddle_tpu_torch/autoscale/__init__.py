"""Elastic autoscaling and the health watchdog, serving half
(counterpart of paddle_tpu/autoscale):

- ``ReplicaAutoscaler`` scales an engine's replica pool (or, through
  ``inference.fabric.FleetEngine``, the whole fleet's) from queue-depth
  and latency signals, in the degrade order scale -> queue -> shed;
- ``HealthWatchdog`` detects hung replicas by monotonic deadline and
  revives or replaces them with bounded retry.

The reference's training half (``world.py``: ``WorldAutoscaler``,
``RankWatchdog``, ``fleet_world_fn``) needs the fault-tolerance
supervisor and sharded checkpoints, ROADMAP queue 5; it is not here.

The live controllers' summed counters are the metrics bus's
"autoscale" section (:func:`summary_snapshot`, registered when the first
controller is made), which ``profiler.summary_dict()`` carries.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

_REG_LOCK = threading.Lock()
_INSTANCES: list = []  # weakrefs of live controllers
_REGISTERED = False


def _track(obj) -> None:
    """Register a controller for :func:`summary_snapshot` (weakref; a
    collected controller drops out)."""
    _register_provider()
    with _REG_LOCK:
        _INSTANCES.append(weakref.ref(obj))


def _register_provider() -> None:
    global _REGISTERED
    with _REG_LOCK:
        if _REGISTERED:
            return
        from ..observability import bus as _bus

        _bus.register_provider("autoscale", summary_snapshot)
        _REGISTERED = True


def summary_snapshot() -> Optional[dict]:
    """Summed counters over the live controllers; None until any counter
    moves."""
    out: dict = {}
    with _REG_LOCK:
        alive = []
        for ref in _INSTANCES:
            obj = ref()
            if obj is None:
                continue
            alive.append(ref)
            for k, v in getattr(obj, "counters", {}).items():
                out[k] = out.get(k, 0) + v
        _INSTANCES[:] = alive
    if not any(out.values()):
        return None
    return out


from .policy import ScalingPolicy  # noqa: E402
from .replica import HealthWatchdog, ReplicaAutoscaler  # noqa: E402

__all__ = ["ScalingPolicy", "ReplicaAutoscaler", "HealthWatchdog",
           "summary_snapshot"]
