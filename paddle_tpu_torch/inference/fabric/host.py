"""Member-side agent: one serving host's presence in the fabric
(counterpart of paddle_tpu/inference/fabric/host.py).

Ties an admin-enabled :class:`~...serving.server.ServingHTTPServer`
(its engines already warmed — the engines' constructors warm before
admission, so by the time the agent registers, the FIRST routed
request hits warm executables: warm-before-admission, fleet edition)
to a :class:`~.membership.HostLease` whose heartbeats publish the
server's live load report.

The agent is also the graceful-exit choreography the resize/preempt
paths use: ``leave()`` marks the lease draining (the router stops new
traffic on the next heartbeat), drains the engines, then deregisters —
so a planned departure never burns the view's failure ladder.
"""
from __future__ import annotations

import logging
import os
import socket
from typing import Optional

from .membership import DEFAULT_PREFIX, HostLease

_LOG = logging.getLogger("paddle_tpu_torch.fabric")


def default_host_id() -> str:
    return f"{socket.gethostname()}-{os.getpid()}"


class HostAgent:
    """Register one admin-enabled serving server into the fleet."""

    def __init__(self, server, store, host_id: Optional[str] = None,
                 endpoint: Optional[str] = None,
                 capacity: Optional[int] = None,
                 prefix: str = DEFAULT_PREFIX,
                 heartbeat_s: float = 0.75, pools=None):
        if not getattr(server, "admin", False):
            raise ValueError(
                "HostAgent needs an admin-enabled server "
                "(ServingHTTPServer(..., admin=True)) — fleet actuation "
                "drives the /admin plane")
        self.server = server
        if pools is not None:
            # role specialization (disaggregated serving): a host joins
            # as pools=("prefill",) or ("decode",) and the router's
            # generation path splits work accordingly — the engines
            # behind both roles are identical, the ROLE is the lease
            pools = [str(p) for p in pools]
        else:
            pools = []
            if server.engine is not None:
                pools.append("predict")
            if server.generator is not None:
                pools.append("generate")
        if capacity is None:
            rep = server.load_report()
            capacity = max(1, int(rep.get("replicas", 1)))
        self.lease = HostLease(
            store,
            host_id or default_host_id(),
            endpoint or f"{server.host}:{server.port}",
            capacity=capacity, pools=pools, prefix=prefix,
            heartbeat_s=heartbeat_s, load_fn=server.load_report)

    @property
    def host_id(self) -> str:
        return self.lease.host_id

    def start(self) -> "HostAgent":
        """Admit this host to routing. The engines are warm already
        (their constructors refuse to admit cold replicas), so joining
        the registry IS the admission gate."""
        gen = self.lease.register()
        _LOG.info("fabric host %s registered (generation %d) at %s",
                  self.lease.host_id, gen, self.lease.endpoint)
        return self

    def leave(self, drain: bool = True, migrate: bool = False) -> None:
        """Graceful departure: draining lease -> engine drain ->
        deregister. Zero in-flight loss, zero ladder burn. With
        ``migrate=True`` in-flight generation streams are exported as
        KV-handoff payloads (their streams end in a 'handoff' line the
        router re-homes onto a survivor) instead of being finished
        here — live migration, the disaggregated-serving drain."""
        self.lease.mark_draining(True)
        self.server.stop(drain=drain, migrate=migrate)
        self.lease.deregister()

    def stop(self, deregister: bool = True) -> None:
        """Tear down the agent only (the server stays up) — tests and
        the SIGKILL path (where nothing runs at all) use the lease
        expiry instead."""
        if deregister:
            self.lease.deregister()
        else:
            self.lease._stop.set()


__all__ = ["HostAgent", "default_host_id"]
