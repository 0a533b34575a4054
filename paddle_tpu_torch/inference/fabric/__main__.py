"""Front-door CLI: one of the fleet's N interchangeable doors
(counterpart of paddle_tpu/inference/fabric/__main__.py).

    python -m paddle_tpu_torch.inference.fabric \
        --store h1:p1,h2:p2,h3:p3 [--port 8080] [--lease_s 3.0] ...

Run as many of these (behind DNS/VIP, or handed to
:class:`~.client.FleetClient`) as availability demands: each door
mounts the shared registry — a single TCPStore endpoint or a
comma-separated quorum-store member list (``distributed.store.
make_store``) — and derives an IDENTICAL member table and affinity
ring from it, so doors need no coordination among themselves. Pure
control plane: the door runs no engine and touches no card.

Prints ``DOOR=<host:port>`` on stdout once serving (the launcher/test
contract), then serves until SIGINT/SIGTERM. ``--embed`` (the
reference's sparse-embedding tier) is refused with exit code 2: the
embedding tier is not ported (ROADMAP queue 6).
"""
from __future__ import annotations

import argparse
import os
import signal
import sys

EMBED_ITEM = ("ROADMAP queue 6 (the embedding tier, "
              "inference/embedding/)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("paddle_tpu_torch.inference.fabric")
    p.add_argument("--store", required=False,
                   default=os.environ.get("FABRIC_STORE", ""),
                   help="registry endpoints: host:port for one "
                        "TCPStore, comma-separated for a QuorumStore")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="bind port (0 = ephemeral, reported on stdout)")
    p.add_argument("--prefix",
                   default=os.environ.get("FABRIC_PREFIX", "fabric"))
    p.add_argument("--lease_s", type=float, default=3.0)
    p.add_argument("--drain_s", type=float, default=2.0)
    p.add_argument("--hop_timeout_s", type=float, default=30.0)
    p.add_argument("--stream_idle_timeout_s", type=float, default=60.0)
    p.add_argument("--max_fleet_queue", type=int, default=256)
    p.add_argument("--embed", action="store_true",
                   help=f"the sparse-embedding tier: refused "
                        f"({EMBED_ITEM})")
    return p


def main(args=None) -> int:
    ns = build_parser().parse_args(args)
    if ns.embed:
        print(f"fabric: --embed is not ported: {EMBED_ITEM}",
              file=sys.stderr)
        return 2
    if not ns.store:
        print("fabric: --store (or FABRIC_STORE) is required",
              file=sys.stderr)
        return 2
    from ...distributed.store import make_store
    from .frontdoor import FabricHTTPServer
    from .membership import MembershipView
    from .router import FabricRouter

    store = make_store(ns.store)
    view = MembershipView(store, prefix=ns.prefix, lease_s=ns.lease_s,
                          drain_s=ns.drain_s).start()
    router = FabricRouter(
        view, hop_timeout_s=ns.hop_timeout_s,
        stream_idle_timeout_s=ns.stream_idle_timeout_s,
        max_fleet_queue=ns.max_fleet_queue)
    fd = FabricHTTPServer(router, host=ns.host, port=ns.port)
    print(f"DOOR={fd.host}:{fd.port}", flush=True)

    # SIGTERM = the operator's graceful stop; serve_forever handles
    # KeyboardInterrupt (SIGINT) itself
    signal.signal(signal.SIGTERM,
                  lambda *_: signal.raise_signal(signal.SIGINT))
    fd.serve_forever()
    try:
        store.stop()
    except Exception:  # noqa: BLE001 — best effort on the way out
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
