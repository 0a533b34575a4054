"""Fleet actuation: the engine contract, spread over N hosts
(counterpart of paddle_tpu/inference/fabric/fleet.py).

:class:`FleetEngine` speaks the exact surface the autoscale controllers
already drive against one local engine — ``replica_states()`` rows
with monotonic ages, ``add_replica`` / ``remove_replica`` /
``revive_replica`` verbs, ``_queue`` depth, ``metrics`` with
``latency_percentiles()``/``shed_total``, a ``scale_headroom_fn``
hook — but implemented over member hosts' ``/admin`` endpoints. The
result: an UNMODIFIED ``ReplicaAutoscaler`` grows/shrinks the whole
fleet's replica pools, and an UNMODIFIED ``HealthWatchdog`` walks its
revive -> replace ladder against a wedged replica on a REMOTE host
exactly as it would a local one (the busy/beat ages in the rows are
computed by the owning host on ITS monotonic clock at snapshot time,
so no cross-host clock comparison ever happens).

Namespacing: replica ids become ``host|front|rid`` and devices
``host|front|device`` — the watchdog's replace-on-another-device
logic then works across hosts for free (a different string IS a
different device), and a fleet id always routes the actuation verb
back to the owning host + engine front.

Only ALIVE members are actuated: a suspect host is mid-ladder in the
membership view — hammering its admin port from the watchdog thread
would just serialize timeouts; eviction handles the host level.
"""
from __future__ import annotations

import threading
from typing import List, Optional

from ..serving.lifecycle import ServingError
from . import _http
from .membership import MembershipView
from .metrics import FabricMetrics
from .router import FabricRouter

_SEP = "|"

# pools whose members carry an /admin plane with replica slots — the
# actuation targets. "prefill"/"decode" are generative engines behind a
# specialized ROLE (disaggregated serving): same front ("generate"),
# different routing — the autoscaler and watchdog drive them like any
# generate host, and because pool membership keys the scale target,
# the two pools grow/shrink independently for free.
_ADMIN_POOLS = {"predict", "generate", "prefill", "decode"}


class _FleetDevice:
    """A (host, front, device) coordinate with the string identity the
    HealthWatchdog's device arithmetic keys on."""

    __slots__ = ("host", "front", "device")

    def __init__(self, host: str, front: str, device: str):
        self.host = host
        self.front = front
        self.device = device

    def __str__(self):
        return f"{self.host}{_SEP}{self.front}{_SEP}{self.device}"

    def __repr__(self):
        return f"_FleetDevice({self})"

    def __eq__(self, other):
        return isinstance(other, _FleetDevice) and str(self) == str(other)

    def __hash__(self):
        return hash(str(self))


def _split_rid(rid: str):
    host, front, raw = str(rid).split(_SEP, 2)
    return host, front, int(raw)


class _FleetBacklog:
    """len() == fleet-wide queued requests (the autoscaler's
    ``len(engine._queue)`` signal) without an HTTP call — it reads the
    heartbeat-published load reports."""

    def __init__(self, view: MembershipView):
        self._view = view

    def __len__(self):
        return int(self._view.fleet_backlog())


class FleetEngine:
    """Engine-contract adapter over the fleet's ``/admin`` plane."""

    def __init__(self, view: MembershipView,
                 router: Optional[FabricRouter] = None,
                 admin_timeout_s: float = 30.0,
                 default_front: Optional[str] = None):
        self.view = view
        self.router = router
        self.admin_timeout_s = float(admin_timeout_s)
        self.default_front = default_front
        self.metrics = router.metrics if router is not None \
            else FabricMetrics()
        self.metrics.member_rows_fn = view.rows
        self._queue = _FleetBacklog(view)
        self._lock = threading.Lock()
        self._rows_cache: List[dict] = []
        self._local_headroom_fn = None

    # the autoscaler assigns engine.scale_headroom_fn in its __init__;
    # delegate to the router so the front door's breaker stretches its
    # fleet queue bound while scale-up headroom remains (the same
    # degrade order the single-host engine runs)
    @property
    def scale_headroom_fn(self):
        if self.router is not None:
            return self.router.scale_headroom_fn
        return self._local_headroom_fn

    @scale_headroom_fn.setter
    def scale_headroom_fn(self, fn):
        if self.router is not None:
            self.router.scale_headroom_fn = fn
        else:
            self._local_headroom_fn = fn

    # ------------------------------------------------------------- admin --
    def _admin(self, host_id: str, method: str, path: str, obj=None):
        m = self.view.get(host_id)
        if m is None:
            raise ValueError(f"no fleet member {host_id!r}")
        try:
            status, body = _http.request_json(
                m.endpoint, method, path, obj,
                timeout=self.admin_timeout_s)
        except _http.HopError as e:
            raise ServingError(
                503, f"admin hop to {host_id} failed: {e!r}"[:500]) \
                from e
        if status == 409:
            # the engine's ValueError surface (replica vanished, last
            # active refusal): the watchdog/autoscaler handle ValueError
            raise ValueError(body.get("error", f"conflict on {host_id}"))
        if status >= 400:
            raise ServingError(status,
                               body.get("error", f"admin {status}"))
        return body

    # ----------------------------------------------------------- contract --
    def replica_states(self) -> List[dict]:
        """Union of every ALIVE member's replica rows, ids/devices
        namespaced. A member whose admin fetch faults contributes no
        rows this poll — its HOST-level failure is the membership
        ladder's job, not the replica watchdog's."""
        rows: List[dict] = []
        for m in self.view.alive():
            if not _ADMIN_POOLS & set(m.pools):
                continue   # embed-only shard host: no /admin plane
            try:
                body = self._admin(m.host_id, "GET", "/admin/replicas")
            except (ServingError, ValueError):
                continue
            for row in body.get("replicas", ()):
                row = dict(row)
                front = row.get("front", "predict")
                row["rid"] = (f"{m.host_id}{_SEP}{front}{_SEP}"
                              f"{row['rid']}")
                row["device"] = (f"{m.host_id}{_SEP}{front}{_SEP}"
                                 f"{row['device']}")
                row["host"] = m.host_id
                rows.append(row)
        with self._lock:
            self._rows_cache = rows
        return rows

    @property
    def _device_pool(self) -> List[_FleetDevice]:
        """Distinct fleet devices from the last replica snapshot (the
        watchdog reads this right after replica_states())."""
        with self._lock:
            rows = list(self._rows_cache)
        seen, pool = set(), []
        for r in rows:
            host, front, dev = r["device"].split(_SEP, 2)
            key = (host, front, dev)
            if key not in seen:
                seen.add(key)
                pool.append(_FleetDevice(host, front, dev))
        return pool

    def _active(self) -> List[dict]:
        with self._lock:
            return [r for r in self._rows_cache
                    if r["state"] == "active"]

    def health(self) -> dict:
        rows = self.view.rows()
        return {
            "status": "ok" if any(r["state"] == "alive" for r in rows)
            else "empty",
            "hosts": rows,
            "replicas": sum(r["replicas"] for r in rows),
            "queue_depth": len(self._queue),
        }

    # ----------------------------------------------------------- actuate --
    def _pick_front(self, member) -> str:
        if self.default_front is not None:
            return self.default_front
        fronts = dict(member.load.get("fronts") or {})
        if not fronts:
            # pool names are ROLES ("prefill"/"decode"), not fronts —
            # anything without a predict engine scales its generator
            return "predict" if "predict" in member.pools else "generate"
        # grow the front that is actually backed up
        return max(fronts.items(),
                   key=lambda kv: int(kv[1].get("queue_depth", 0)))[0]

    def add_replica(self, device=None, warm: bool = True) -> dict:
        """Grow the fleet by one replica: on `device`'s host (the
        watchdog's replace-elsewhere path) or the least-loaded ALIVE
        host. The member engine warms before admission as always."""
        if device is not None:
            if not isinstance(device, _FleetDevice):
                host, front, dev = str(device).split(_SEP, 2)
                device = _FleetDevice(host, front, dev)
            host_id, front = device.host, device.front
            payload = {"front": front, "action": "add",
                       "device": device.device, "warm": bool(warm)}
        else:
            # only hosts that actually serve a decode pool are scale
            # targets: an embedding-shard-only member ("embed" pool)
            # has no /admin plane and no replica slots to grow
            alive = [m for m in self.view.alive()
                     if _ADMIN_POOLS & set(m.pools)]
            if not alive:
                raise ServingError(503, "no live hosts to scale up on")
            m = min(alive, key=lambda mm: (
                int(mm.load.get("queue_depth", 0)) /
                float(max(mm.capacity, 1))))
            host_id, front = m.host_id, self._pick_front(m)
            payload = {"front": front, "action": "add",
                       "warm": bool(warm)}
        report = self._admin(host_id, "POST", "/admin/scale", payload)
        report["rid"] = f"{host_id}{_SEP}{front}{_SEP}{report['rid']}"
        report["host"] = host_id
        return report

    def remove_replica(self, rid: Optional[str] = None,
                       drain: bool = True, timeout: float = 30.0) -> dict:
        """Retire one replica fleet-wide. Unnamed removal picks the
        host holding the most active replicas (shrink where the
        capacity is), and lets that host's engine choose the replica —
        its own last-active refusal still applies per host."""
        if rid is not None:
            host_id, front, raw = _split_rid(rid)
            payload = {"front": front, "action": "remove", "rid": raw,
                       "drain": bool(drain), "timeout": float(timeout)}
        else:
            counts: dict = {}
            for r in self._active():
                host, front, _ = r["rid"].split(_SEP, 2)
                counts[(host, front)] = counts.get((host, front), 0) + 1
            if not counts:
                self.replica_states()
                for r in self._active():
                    host, front, _ = r["rid"].split(_SEP, 2)
                    counts[(host, front)] = \
                        counts.get((host, front), 0) + 1
            if not counts:
                raise ValueError("no removable replica in the fleet")
            (host_id, front), _n = max(counts.items(),
                                       key=lambda kv: kv[1])
            payload = {"front": front, "action": "remove",
                       "drain": bool(drain), "timeout": float(timeout)}
        report = self._admin(host_id, "POST", "/admin/scale", payload)
        report["rid"] = f"{host_id}{_SEP}{front}{_SEP}{report['rid']}"
        report["host"] = host_id
        return report

    def revive_replica(self, rid: str) -> dict:
        """The watchdog's cross-host revive: bump the wedged REMOTE
        worker's generation on its owning host."""
        host_id, front, raw = _split_rid(rid)
        report = self._admin(host_id, "POST", "/admin/scale",
                             {"front": front, "action": "revive",
                              "rid": raw})
        report["rid"] = rid
        report["host"] = host_id
        return report

    def drain_host(self, host_id: str, migrate: bool = False) -> dict:
        """Host-level graceful drain (operator/evict-with-grace path):
        the member flips to draining (router stops routing to it via
        its record) and its engines finish in-flight work. With
        ``migrate=True`` the generative front exports in-flight
        streams as KV-handoff payloads the router re-homes onto a
        survivor instead of finishing them — live migration."""
        return self._admin(host_id, "POST", "/admin/drain",
                           {"migrate": bool(migrate)})


__all__ = ["FleetEngine"]
