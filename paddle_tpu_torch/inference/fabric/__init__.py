"""paddle_tpu_torch.inference.fabric — the cross-host serving fabric
(counterpart of paddle_tpu/inference/fabric): one fault-tolerant front
door over N serving hosts.

- :mod:`.membership` — hosts register ``{host_id, endpoint, capacity,
  pools}`` into the store under a heartbeat-renewed lease; the front
  door's :class:`MembershipView` runs the failure ladder alive ->
  suspect (probe) -> evicted on observer-local monotonic deadlines.
- :mod:`.router` — least-loaded ``/predict``, KV-aware and
  prefix-resident ``/generate``, the consistent-hash ring, one retry
  while nothing has streamed, replay-resume on a survivor, migration
  splices and the disaggregated prefill leg; SCALE -> QUEUE -> SHED.
- :mod:`.frontdoor` — the HTTP face: relay, aggregated ``/healthz`` and
  one merged host-labelled ``/metrics``.
- :mod:`.fleet` — :class:`FleetEngine`, the engine contract over the
  members' ``/admin`` planes, so the autoscale controllers drive the
  whole fleet.
- :mod:`.host` — the member-side agent (admin-enabled server + lease).
- :mod:`.client` — :class:`FleetClient`, client-side failover over N
  front doors (``python -m paddle_tpu_torch.inference.fabric`` runs one).
- :mod:`.handoff` — the KV-handoff wire format.

Only the hosts' engines touch the card; a front door is control plane.
"""
from __future__ import annotations

from . import handoff  # noqa: F401
from .client import FleetClient
from .fleet import FleetEngine
from .frontdoor import FabricHTTPServer
from .host import HostAgent
from .membership import HostLease, Member, MembershipView
from .metrics import FabricMetrics, merge_expositions
from .router import FabricRouter, build_ring, ring_hosts

__all__ = ["FabricHTTPServer", "FabricRouter", "FleetClient",
           "FleetEngine", "HostAgent", "HostLease", "Member",
           "MembershipView", "FabricMetrics", "merge_expositions",
           "build_ring", "ring_hosts", "handoff"]
