"""Input-pipeline metrics (counterpart of
paddle_tpu/io/pipeline/metrics.py).

Every Pipeline owns a PipelineMetrics; the module sums all pipelines of
the session into the ``"input_pipeline"`` section of the metrics bus
(observability/bus.py), which ``profiler.summary_dict()`` carries.

The headline number is the **starvation fraction**: the share of the
consumer's active window spent blocked inside ``next()`` waiting for a
batch. Above zero, the training loop waits for input and the profiler's
op table measures idle time as well as compute: more workers or a
device prefetch come before any kernel work. ``device_put_s`` is the
prefetch's copy time, pinning and the copy to the card included.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

_REG_LOCK = threading.Lock()
# strong references to PipelineMetrics (a few counters each): the section
# sums the session, so a pipeline's numbers outlive the pipeline (a fit
# loop builds and drops pipelines, then the summary is read)
_METRICS: list = []
_REGISTERED = False


class PipelineMetrics:
    """Counters for one Pipeline, accumulated across epochs/iterators.

    The consumer's numbers (batches, wait_s, the active span) are written
    by the thread calling ``next()``, the workers' (decode_s, put_s) by
    the stage threads: each field has one writer, and the lock guards
    snapshots of several fields.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.batches = 0            # yielded to the consumer
        self.samples = 0            # samples decoded (__getitem__ calls)
        self.wait_s = 0.0           # consumer blocked in next() (starvation)
        self.decode_s = 0.0         # worker time fetching+collating
        self.put_s = 0.0            # device-transfer enqueue time
        self.epochs_started = 0
        self.resumes = 0
        self.fast_forwarded_batches = 0  # skipped by index arithmetic
        self._first_next: Optional[float] = None
        self._last_next: Optional[float] = None
        # live queue depths are read straight off the current iterator
        self.host_queue_depth = 0
        self.device_queue_depth = 0

    # ------------------------------------------------------------ hooks --
    def on_next(self, wait: float):
        now = time.perf_counter()
        with self._lock:
            if self._first_next is None:
                self._first_next = now - wait
            self._last_next = now
            self.batches += 1
            self.wait_s += wait

    def on_decode(self, n_samples: int, seconds: float):
        with self._lock:
            self.samples += n_samples
            self.decode_s += seconds

    def on_put(self, seconds: float):
        with self._lock:
            self.put_s += seconds

    # ------------------------------------------------------- derived -----
    @property
    def active_s(self) -> float:
        """The consumer's active window, from entering the first next() to
        leaving the last: the starvation fraction's denominator."""
        with self._lock:
            if self._first_next is None or self._last_next is None:
                return 0.0
            return max(0.0, self._last_next - self._first_next)

    @property
    def starvation_fraction(self) -> float:
        span = self.active_s
        if span <= 0:
            return 0.0
        return min(1.0, self.wait_s / span)

    @property
    def batches_per_sec(self) -> float:
        span = self.active_s
        if span <= 0:
            return 0.0
        return self.batches / span

    def snapshot(self) -> dict:
        with self._lock:
            span = 0.0
            if self._first_next is not None and self._last_next is not None:
                span = max(0.0, self._last_next - self._first_next)
            out = {
                "batches": self.batches,
                "samples_decoded": self.samples,
                "wait_s": round(self.wait_s, 4),
                "active_s": round(span, 4),
                "decode_s": round(self.decode_s, 4),
                "device_put_s": round(self.put_s, 4),
                "epochs_started": self.epochs_started,
                "resumes": self.resumes,
                "fast_forwarded_batches": self.fast_forwarded_batches,
                "host_queue_depth": self.host_queue_depth,
                "device_queue_depth": self.device_queue_depth,
            }
        out["starvation_fraction"] = round(
            min(1.0, out["wait_s"] / span), 4) if span > 0 else 0.0
        out["batches_per_sec"] = round(self.batches / span, 2) \
            if span > 0 else 0.0
        return out


# --------------------------------------------------------------- registry --
def track(pipeline) -> None:
    """Register a Pipeline's metrics for the session-aggregate digest."""
    _register_provider()
    with _REG_LOCK:
        _METRICS.append(pipeline.metrics)


def summary_snapshot() -> Optional[dict]:
    """The 'input_pipeline' section: the session's totals over every
    pipeline made; None until a pipeline has yielded a batch."""
    totals = {"pipelines": 0, "batches": 0, "samples_decoded": 0,
              "wait_s": 0.0, "active_s": 0.0, "decode_s": 0.0,
              "device_put_s": 0.0, "epochs_started": 0, "resumes": 0,
              "fast_forwarded_batches": 0, "host_queue_depth": 0,
              "device_queue_depth": 0}
    with _REG_LOCK:
        metrics = list(_METRICS)
    for m in metrics:
        snap = m.snapshot()
        totals["pipelines"] += 1
        for k in ("batches", "samples_decoded", "epochs_started",
                  "resumes", "fast_forwarded_batches",
                  "host_queue_depth", "device_queue_depth"):
            totals[k] += snap[k]
        for k in ("wait_s", "active_s", "decode_s", "device_put_s"):
            totals[k] = round(totals[k] + snap[k], 4)
    if totals["batches"] == 0:
        return None
    span = totals["active_s"]
    totals["starvation_fraction"] = round(
        min(1.0, totals["wait_s"] / span), 4) if span > 0 else 0.0
    totals["batches_per_sec"] = round(totals["batches"] / span, 2) \
        if span > 0 else 0.0
    return totals


def _register_provider() -> None:
    global _REGISTERED
    with _REG_LOCK:
        if _REGISTERED:
            return
        from ...observability import bus as _bus

        _bus.register_provider("input_pipeline", summary_snapshot)
        _REGISTERED = True


__all__ = ["PipelineMetrics", "summary_snapshot", "track"]
