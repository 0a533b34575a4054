"""Serving metrics (counterpart of paddle_tpu/inference/serving/metrics.py).

The predict engine's metric store, `ServingMetrics`: QPS, latency
percentiles, queue depth, batch occupancy, per-bucket first-call and hit
counters, shed, deadline and error counts, exported as Prometheus text
(`prometheus_text()`, served at /metrics under the reference's
`paddle_serving_*` families) and as a structured `snapshot()`. The
bucket counters are keyed by (batch bucket, shape key), one program
shape each; "compiles" counts a shape's first call on a device that the
warm-up had not run (eager PyTorch compiles nothing), "hits" the rest.

`EngineRegistry` keeps weak references to the live engines (or fabric
routers) of one section and merges their snapshots: `track_engine`
registers a predict engine, `aggregate_snapshot` merges the "serving"
section. The first engine a registry tracks registers the section's
merge function on the metrics bus (observability/bus.py), so that
`profiler.summary_dict()` carries the section while an engine lives and
drops it once none does. `percentiles` and `rate` are shared with the
generation engine.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ...testing.racecheck import shared_state as _shared_state


class EngineRegistry:
    """Live-engine weakref list of one section ("serving", "fabric"),
    shared by the tiers so the dead-ref pruning lives in one place.
    `provider` is the section's merge function, registered on the
    metrics bus the first time an engine is tracked (a registry without
    one publishes no section)."""

    def __init__(self, section: str, provider):
        self.section = section
        self.provider = provider
        self._lock = threading.Lock()
        self._registered = False
        self._engines: list = []

    def track(self, engine) -> None:
        import weakref

        with self._lock:
            if not self._registered and callable(self.provider):
                from ...observability import bus as _bus

                _bus.register_provider(self.section, self.provider)
                self._registered = True
            self._engines.append(weakref.ref(engine))

    def snapshots(self) -> List[dict]:
        """Prune dead refs; return the live engines' metric snapshots."""
        out = []
        with self._lock:
            alive = []
            for ref in self._engines:
                eng = ref()
                if eng is not None:
                    alive.append(ref)
                    out.append(eng.metrics.snapshot())
            self._engines[:] = alive
        return out


def percentiles(vals) -> Dict[str, float]:
    """Nearest-rank p50/p95/p99 over an unsorted value sequence (the
    reference's one rank rule for every serving tier)."""
    lat = sorted(vals)
    if not lat:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}

    def pct(p):
        i = min(int(p * (len(lat) - 1) + 0.5), len(lat) - 1)
        return lat[i]

    return {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}


def rate(num, den) -> float:
    """Safe ratio for snapshot fields (0.0 on an empty denominator).
    Snapshot keys ending in ``_rate`` are left out of cross-engine
    aggregation: a ratio of sums is not a sum of ratios."""
    return round(num / den, 4) if den else 0.0


def track_engine(engine):
    _REGISTRY.track(engine)


def aggregate_snapshot() -> Optional[dict]:
    """Merged snapshot over the live predict engines (None: no engine
    ever ran)."""
    snaps = _REGISTRY.snapshots()
    if not snaps:
        return None
    if len(snaps) == 1:
        return snaps[0]
    # additive counters and gauges sum, extrema take the max, averages
    # recompute batch-weighted (a sum would report an occupancy past
    # max_batch_size on a host of several engines)
    _MAX = {"max_batch_occupancy"}
    _SKIP = {"avg_batch_occupancy", "latency_ms", "occupancy_hist",
             "buckets"}
    out = dict(snaps[0])
    for s in snaps[1:]:
        for k, v in s.items():
            if k in _SKIP:
                continue
            if k in _MAX:
                out[k] = max(out.get(k, 0), v)
            elif isinstance(v, (int, float)) and \
                    isinstance(out.get(k), (int, float)):
                out[k] = out[k] + v
    occ_n = sum(sn["avg_batch_occupancy"] * sn["batches_total"]
                for sn in snaps)
    occ_d = sum(sn["batches_total"] for sn in snaps)
    out["avg_batch_occupancy"] = round(occ_n / occ_d, 3) if occ_d else 0.0
    out["latency_ms"] = {  # conservative: the worst engine's quantiles
        q: max(sn["latency_ms"][q] for sn in snaps)
        for q in ("p50", "p95", "p99")}
    hist: dict = {}
    for sn in snaps:
        for occ, cnt in sn["occupancy_hist"].items():
            hist[occ] = hist.get(occ, 0) + cnt
    out["occupancy_hist"] = dict(sorted(hist.items()))
    buckets: dict = {}
    for sn in snaps:
        for key, st in sn["buckets"].items():
            agg = buckets.setdefault(key, {"compiles": 0, "hits": 0})
            agg["compiles"] += st["compiles"]
            agg["hits"] += st["hits"]
    out["buckets"] = dict(sorted(buckets.items()))
    out["engines"] = len(snaps)
    return out


_REGISTRY = EngineRegistry("serving", aggregate_snapshot)


@_shared_state("requests_total", "responses_total", "rejected_total",
               "shed_total", "deadline_expired_total", "failed_total",
               "batches_total", "batch_splits_total", "rows_total",
               "padded_rows_total", "occupancy_hist", "bucket_stats",
               "_latencies", "_completions")
class ServingMetrics:
    """Thread-safe metric store for one engine.

    Latency percentiles come from a bounded ring of recent samples (not
    a lossy histogram) — at serving rates the last few thousand samples
    ARE the distribution that matters. QPS is completions over a sliding
    window.
    """

    def __init__(self, latency_ring: int = 4096, qps_window_s: float = 30.0):
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._qps_window = float(qps_window_s)
        if latency_ring < 1:
            raise ValueError("latency_ring must be >= 1")
        # counters
        self.requests_total = 0          # accepted into the queue
        self.responses_total = 0         # completed OK
        self.rejected_total: Dict[str, int] = {}   # reason -> count (4xx)
        self.shed_total = 0              # circuit breaker 503s
        self.deadline_expired_total = 0  # queue-expiry 503s
        self.failed_total = 0            # runtime 5xx
        self.batches_total = 0           # executed device batches
        self.batch_splits_total = 0      # split-and-retry events
        self.rows_total = 0              # real rows executed
        self.padded_rows_total = 0       # pad rows added by bucketing
        # histograms / rings — both BOUNDED: a long-running server must
        # hold memory flat regardless of request count. Percentiles come
        # from the fixed-size latency ring (the most recent
        # `latency_ring` samples ARE the distribution that matters at
        # serving rates); the QPS window actively EVICTS timestamps
        # older than qps_window_s on every record/read, so its length —
        # and the qps() scan — is O(completions inside the window), not
        # O(lifetime requests), with a hard maxlen backstop for rate
        # spikes
        self.occupancy_hist: Dict[int, int] = {}   # requests-per-batch
        self.bucket_stats: Dict[Tuple[int, str], Dict[str, int]] = {}
        self._latencies = deque(maxlen=int(latency_ring))  # seconds
        self._completions = deque(maxlen=65536)            # timestamps
        # gauge callbacks (engine queue depth / active replica count),
        # set by the engine
        self.queue_depth_fn = lambda: 0
        self.replicas_fn = lambda: 0

    # ------------------------------------------------------------ record --
    def on_accept(self):
        with self._lock:
            self.requests_total += 1

    def on_reject(self, reason: str):
        with self._lock:
            self.rejected_total[reason] = \
                self.rejected_total.get(reason, 0) + 1

    def on_shed(self):
        with self._lock:
            self.shed_total += 1

    def on_deadline_expired(self):
        with self._lock:
            self.deadline_expired_total += 1

    def on_failed(self, n: int = 1):
        with self._lock:
            self.failed_total += n

    def on_batch(self, n_requests: int, rows: int, bucket: int,
                 shape_key: str, compiled: bool):
        with self._lock:
            self.batches_total += 1
            self.rows_total += rows
            self.padded_rows_total += max(bucket - rows, 0)
            self.occupancy_hist[n_requests] = \
                self.occupancy_hist.get(n_requests, 0) + 1
            st = self.bucket_stats.setdefault((bucket, shape_key),
                                              {"compiles": 0, "hits": 0})
            st["compiles" if compiled else "hits"] += 1

    def on_split(self):
        with self._lock:
            self.batch_splits_total += 1

    def _evict_completions_locked(self, now: float) -> None:
        horizon = now - self._qps_window
        comp = self._completions
        while comp and comp[0] < horizon:
            comp.popleft()

    def on_complete(self, latency_s: float, n: int = 1):
        now = time.monotonic()
        with self._lock:
            self.responses_total += n
            self._latencies.append(float(latency_s))
            self._evict_completions_locked(now)
            for _ in range(n):
                self._completions.append(now)

    # ------------------------------------------------------------- query --
    def latency_percentiles(self) -> Dict[str, float]:
        with self._lock:
            lat = list(self._latencies)
        return percentiles(lat)

    def qps(self) -> float:
        now = time.monotonic()
        with self._lock:
            self._evict_completions_locked(now)
            n = len(self._completions)
        window = min(self._qps_window, max(now - self._t0, 1e-9))
        return n / window

    def max_occupancy(self) -> int:
        with self._lock:
            return max(self.occupancy_hist) if self.occupancy_hist else 0

    def snapshot(self) -> dict:
        """Structured digest (the reference also merges it into its
        profiler's summary_dict as the 'serving' section)."""
        pct = self.latency_percentiles()
        # gauge callbacks BEFORE taking our lock: replicas_fn walks the
        # engine pool under the engine cv, and the engine records
        # metrics while holding that cv — evaluating the callback
        # inside our lock is a metrics->cv / cv->metrics order cycle
        queue_depth = int(self.queue_depth_fn())
        replicas = int(self.replicas_fn())
        with self._lock:
            occ_n = sum(k * v for k, v in self.occupancy_hist.items())
            occ_d = sum(self.occupancy_hist.values())
            out = {
                "requests_total": self.requests_total,
                "responses_total": self.responses_total,
                "rejected_total": sum(self.rejected_total.values()),
                "shed_total": self.shed_total,
                "deadline_expired_total": self.deadline_expired_total,
                "failed_total": self.failed_total,
                "batches_total": self.batches_total,
                "batch_splits_total": self.batch_splits_total,
                "rows_total": self.rows_total,
                "padded_rows_total": self.padded_rows_total,
                "avg_batch_occupancy": round(occ_n / occ_d, 3) if occ_d
                else 0.0,
                "max_batch_occupancy": max(self.occupancy_hist)
                if self.occupancy_hist else 0,
                "occupancy_hist": dict(sorted(self.occupancy_hist.items())),
                "buckets": {
                    f"b{b}:{sk}": dict(st)
                    for (b, sk), st in sorted(self.bucket_stats.items())},
                "queue_depth": queue_depth,
                "replicas": replicas,
            }
        out["latency_ms"] = {k: round(v * 1e3, 3) for k, v in pct.items()}
        out["qps"] = round(self.qps(), 3)
        return out

    # --------------------------------------------------------- prometheus --
    def prometheus_text(self) -> str:
        """Prometheus exposition text format (served at /metrics)."""
        s = self.snapshot()
        lines: List[str] = []

        def metric(name, mtype, value, help_=None, labels=None):
            if help_:
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {mtype}")
            lab = ""
            if labels:
                lab = "{" + ",".join(f'{k}="{v}"'
                                     for k, v in labels.items()) + "}"
            lines.append(f"{name}{lab} {value}")

        metric("paddle_serving_requests_total", "counter",
               s["requests_total"], "requests accepted into the queue")
        metric("paddle_serving_responses_total", "counter",
               s["responses_total"], "requests completed successfully")
        metric("paddle_serving_rejected_total", "counter",
               s["rejected_total"], "requests rejected at decode/shape check")
        metric("paddle_serving_shed_total", "counter", s["shed_total"],
               "requests shed by the circuit breaker (503)")
        metric("paddle_serving_deadline_expired_total", "counter",
               s["deadline_expired_total"], "requests expired in queue (503)")
        metric("paddle_serving_failed_total", "counter", s["failed_total"],
               "requests failed at runtime (500)")
        metric("paddle_serving_batches_total", "counter", s["batches_total"],
               "device batches executed")
        metric("paddle_serving_batch_splits_total", "counter",
               s["batch_splits_total"], "batch split-and-retry events")
        metric("paddle_serving_rows_total", "counter", s["rows_total"],
               "real rows executed")
        metric("paddle_serving_padded_rows_total", "counter",
               s["padded_rows_total"], "pad rows added by bucketing")
        metric("paddle_serving_queue_depth", "gauge", s["queue_depth"],
               "current request-queue depth")
        metric("paddle_serving_replicas", "gauge", s["replicas"],
               "active predictor replicas")
        metric("paddle_serving_qps", "gauge", s["qps"],
               "completions per second (sliding window)")
        lines.append("# HELP paddle_serving_latency_seconds request latency "
                     "quantiles over the recent-sample ring")
        lines.append("# TYPE paddle_serving_latency_seconds summary")
        for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
            lines.append(
                f'paddle_serving_latency_seconds{{quantile="{q}"}} '
                f'{s["latency_ms"][key] / 1e3:.6f}')
        # labeled counter family, NOT prometheus-native histogram type:
        # occupancy is a small discrete domain (1..max_batch_size) and a
        # TYPE histogram without _bucket{le=}/_sum/_count would fail the
        # exposition-format parser and poison the whole scrape
        lines.append("# HELP paddle_serving_batch_occupancy_total "
                     "executed batches by requests-coalesced-per-batch")
        lines.append("# TYPE paddle_serving_batch_occupancy_total counter")
        for occ, cnt in s["occupancy_hist"].items():
            lines.append(
                f'paddle_serving_batch_occupancy_total'
                f'{{occupancy="{occ}"}} {cnt}')
        lines.append("# HELP paddle_serving_bucket_executions executions "
                     "per (batch-bucket, shape-key) executable")
        lines.append("# TYPE paddle_serving_bucket_executions counter")
        for key, st in s["buckets"].items():
            b, _, sk = key.partition(":")
            for kind in ("compiles", "hits"):
                lines.append(
                    f'paddle_serving_bucket_executions{{bucket="{b[1:]}",'
                    f'shape="{sk}",kind="{kind}"}} {st[kind]}')
        return "\n".join(lines) + "\n"


__all__ = ["EngineRegistry", "ServingMetrics", "aggregate_snapshot",
           "percentiles", "rate", "track_engine"]
