"""Fabric observability: ``paddle_fabric_*`` metrics + the merged
front-door exposition (counterpart of
paddle_tpu/inference/fabric/metrics.py).

Two faces, matching the serving/generation tiers:

- :class:`FabricMetrics` — the router's own counters (forwards,
  retries, sheds, stream breaks), hop-latency percentiles, plus the
  member table re-exported as per-host gauges. Live routers are
  tracked in the ``"fabric"`` section's EngineRegistry
  (:func:`aggregate_snapshot` merges them), which the metrics bus
  carries into ``profiler.summary_dict()``.
- :func:`merge_expositions` — member hosts' own ``/metrics`` scrapes
  (``paddle_serving_*`` / ``paddle_generate_*`` families) folded into
  ONE exposition by injecting a ``host=`` label into every sample, so
  a single scrape of the front door sees the whole fleet without name
  collisions (two hosts' un-labeled counters would otherwise be
  duplicate series).
"""
from __future__ import annotations

import re
import threading
from collections import deque
from typing import Callable, Dict, List, Optional

from ...testing.racecheck import shared_state as _shared_state
from ..serving.metrics import EngineRegistry, percentiles


def track_router(router) -> None:
    _REGISTRY.track(router)


def aggregate_snapshot() -> Optional[dict]:
    """Merged 'fabric' digest over live routers (None = never ran)."""
    snaps = _REGISTRY.snapshots()
    if not snaps:
        return None
    if len(snaps) == 1:
        return snaps[0]
    out = dict(snaps[0])
    for s in snaps[1:]:
        for k, v in s.items():
            if isinstance(v, (int, float)) and \
                    isinstance(out.get(k), (int, float)) and \
                    not k.startswith(("hop_latency_", "hosts_")):
                out[k] = out[k] + v
    out["routers"] = len(snaps)
    return out


_REGISTRY = EngineRegistry("fabric", aggregate_snapshot)


@_shared_state("requests_total", "forwards_total", "retries_total",
               "failed_total", "shed_total", "no_host_total",
               "streams_total", "streams_broken_total",
               "stream_tokens_total", "streams_resumed_total",
               "streams_migrated_total", "prefill_handoffs_total",
               "_hop_lat")
class FabricMetrics:
    """Thread-safe metric store for one FabricRouter."""

    def __init__(self, ring: int = 4096):
        self._lock = threading.Lock()
        self.requests_total: Dict[str, int] = {}   # route -> count
        self.forwards_total: Dict[str, int] = {}   # host -> count
        self.retries_total = 0
        self.failed_total = 0
        self.shed_total = 0
        self.no_host_total = 0
        self.streams_total = 0
        self.streams_broken_total = 0
        self.stream_tokens_total = 0
        # disaggregated serving: prefill->decode handoffs relayed,
        # migrate-on-drain re-homes, and mid-stream replay-resumes
        self.streams_resumed_total = 0
        self.streams_migrated_total = 0
        self.prefill_handoffs_total = 0
        self._hop_lat = deque(maxlen=int(ring))    # seconds, non-stream
        # wired by the router/front door
        self.member_rows_fn: Callable[[], List[dict]] = lambda: []
        self.membership_counters_fn: Callable[[], dict] = lambda: {}
        self.outstanding_fn: Callable[[], int] = lambda: 0

    # ------------------------------------------------------------ record --
    def on_request(self, route: str):
        with self._lock:
            self.requests_total[route] = \
                self.requests_total.get(route, 0) + 1

    def on_forward(self, host: str):
        with self._lock:
            self.forwards_total[host] = \
                self.forwards_total.get(host, 0) + 1

    def on_retry(self):
        with self._lock:
            self.retries_total += 1

    def on_failed(self):
        with self._lock:
            self.failed_total += 1

    def on_shed(self):
        with self._lock:
            self.shed_total += 1

    def on_no_host(self):
        with self._lock:
            self.no_host_total += 1

    def on_hop_ok(self, latency_s: float):
        with self._lock:
            self._hop_lat.append(float(latency_s))

    def on_stream(self, tokens: int, broken: bool):
        with self._lock:
            self.streams_total += 1
            self.stream_tokens_total += int(tokens)
            if broken:
                self.streams_broken_total += 1

    def on_resumed(self):
        with self._lock:
            self.streams_resumed_total += 1

    def on_migrated(self):
        with self._lock:
            self.streams_migrated_total += 1

    def on_prefill_handoff(self):
        with self._lock:
            self.prefill_handoffs_total += 1

    # ------------------------------------------------------------- query --
    def latency_percentiles(self) -> Dict[str, float]:
        """Hop-latency percentiles (seconds) — the ReplicaAutoscaler's
        p95 signal when it drives the fleet."""
        with self._lock:
            lat = list(self._hop_lat)
        return percentiles(lat)

    @property
    def responses_total(self) -> int:
        with self._lock:
            return sum(self.forwards_total.values())

    def snapshot(self) -> dict:
        pct = self.latency_percentiles()
        rows = self.member_rows_fn()
        # gauge callback BEFORE our lock: outstanding_fn takes the
        # router's lock — callback-inside-lock is the order-cycle shape
        # serving/metrics.py snapshot documents
        outstanding = int(self.outstanding_fn())
        with self._lock:
            out = {
                "requests_total": sum(self.requests_total.values()),
                "forwards_total": sum(self.forwards_total.values()),
                "retries_total": self.retries_total,
                "failed_total": self.failed_total,
                "shed_total": self.shed_total,
                "no_host_total": self.no_host_total,
                "streams_total": self.streams_total,
                "streams_broken_total": self.streams_broken_total,
                "stream_tokens_total": self.stream_tokens_total,
                "streams_resumed_total": self.streams_resumed_total,
                "streams_migrated_total": self.streams_migrated_total,
                "prefill_handoffs_total": self.prefill_handoffs_total,
                "outstanding": outstanding,
            }
        out["hop_latency_ms"] = {k: round(v * 1e3, 3)
                                 for k, v in pct.items()}
        out["hosts_alive"] = sum(1 for r in rows if r["state"] == "alive")
        out["hosts_suspect"] = sum(1 for r in rows
                                   if r["state"] == "suspect")
        for k, v in (self.membership_counters_fn() or {}).items():
            out[f"membership_{k}"] = v
        return out

    # --------------------------------------------------------- prometheus --
    def prometheus_text(self) -> str:
        s = self.snapshot()
        rows = self.member_rows_fn()
        lines: List[str] = []

        def metric(name, mtype, value, help_):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {mtype}")
            lines.append(f"{name} {value}")

        metric("paddle_fabric_requests_total", "counter",
               s["requests_total"], "requests entering the front door")
        metric("paddle_fabric_forwards_total", "counter",
               s["forwards_total"], "hops forwarded to member hosts")
        metric("paddle_fabric_retries_total", "counter",
               s["retries_total"],
               "non-streamed requests retried on another host")
        metric("paddle_fabric_failed_total", "counter", s["failed_total"],
               "requests failed after the retry budget")
        metric("paddle_fabric_shed_total", "counter", s["shed_total"],
               "requests shed fleet-wide (503)")
        metric("paddle_fabric_no_host_total", "counter",
               s["no_host_total"], "requests refused with zero live hosts")
        metric("paddle_fabric_streams_total", "counter",
               s["streams_total"], "streamed generations relayed")
        metric("paddle_fabric_streams_broken_total", "counter",
               s["streams_broken_total"],
               "streams broken mid-relay (member lost after first token)")
        metric("paddle_fabric_streams_resumed_total", "counter",
               s["streams_resumed_total"],
               "streams replay-resumed on a survivor after host loss")
        metric("paddle_fabric_streams_migrated_total", "counter",
               s["streams_migrated_total"],
               "streams re-homed via a migrate-on-drain KV handoff")
        metric("paddle_fabric_prefill_handoffs_total", "counter",
               s["prefill_handoffs_total"],
               "prefill-pool handoffs imported into decode hosts")
        metric("paddle_fabric_outstanding", "gauge", s["outstanding"],
               "hops currently in flight")
        for k in ("suspects", "evictions", "rejoins", "leaves"):
            metric(f"paddle_fabric_membership_{k}_total", "counter",
                   s.get(f"membership_{k}", 0),
                   f"membership {k} observed by this front door")
        lines.append("# HELP paddle_fabric_hop_latency_seconds non-stream "
                     "hop latency quantiles")
        lines.append("# TYPE paddle_fabric_hop_latency_seconds summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(
                f'paddle_fabric_hop_latency_seconds{{quantile="{q}"}} '
                f'{s["hop_latency_ms"][key] / 1e3:.6f}')
        # the member table, one gauge row per host
        lines.append("# HELP paddle_fabric_member_state member state "
                     "(1 = host is in this state)")
        lines.append("# TYPE paddle_fabric_member_state gauge")
        for r in rows:
            lines.append(
                f'paddle_fabric_member_state{{host="{r["host"]}",'
                f'state="{r["state"]}",generation="{r["generation"]}"}} 1')
        lines.append("# HELP paddle_fabric_member_lease_age_seconds time "
                     "since the last observed lease renewal")
        lines.append("# TYPE paddle_fabric_member_lease_age_seconds gauge")
        for r in rows:
            lines.append(
                f'paddle_fabric_member_lease_age_seconds'
                f'{{host="{r["host"]}"}} {r["lease_age_s"]:.3f}')
        lines.append("# HELP paddle_fabric_member_queue_depth member-"
                     "reported request queue depth")
        lines.append("# TYPE paddle_fabric_member_queue_depth gauge")
        for r in rows:
            lines.append(
                f'paddle_fabric_member_queue_depth{{host="{r["host"]}"}} '
                f'{r["queue_depth"]}')
        lines.append("# HELP paddle_fabric_forwards_by_host_total hops "
                     "forwarded per member host")
        lines.append("# TYPE paddle_fabric_forwards_by_host_total counter")
        with self._lock:
            items = sorted(self.forwards_total.items())
        for host, n in items:
            lines.append(
                f'paddle_fabric_forwards_by_host_total'
                f'{{host="{host}"}} {n}')
        return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})?\s+(\S+.*)$")


def merge_expositions(parts: Dict[str, str]) -> str:
    """Fold member hosts' Prometheus text into one exposition by
    injecting ``host="<id>"`` into every sample line. HELP/TYPE lines
    are kept once per metric name (first writer wins); malformed lines
    are dropped rather than poisoning the whole scrape."""
    out: List[str] = []
    seen_meta = set()
    for host in sorted(parts):
        for line in (parts[host] or "").splitlines():
            line = line.rstrip()
            if not line:
                continue
            if line.startswith("#"):
                toks = line.split(None, 3)
                key = tuple(toks[1:3]) if len(toks) >= 3 else (line,)
                if key in seen_meta:
                    continue
                seen_meta.add(key)
                out.append(line)
                continue
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue
            name, labels, val = m.groups()
            inner = labels[1:-1].strip() if labels else ""
            lab = f'host="{host}"' + (f",{inner}" if inner else "")
            out.append(f"{name}{{{lab}}} {val}")
    return "\n".join(out) + ("\n" if out else "")


__all__ = ["FabricMetrics", "track_router", "aggregate_snapshot",
           "merge_expositions"]
