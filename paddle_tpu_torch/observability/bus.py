"""Run-wide metrics bus (counterpart of paddle_tpu/observability/bus.py).

One registry for what the port's subsystems report:

- **summary providers**: the named ``fn() -> dict | None`` sections of
  ``profiler.summary_dict()`` ("serving", "fabric", "autoscale",
  "input_pipeline"). A raising provider is logged once and skipped, so
  it never sinks the digest; registering a key again replaces its entry.
- **per-step scalar series**: ``record_step(step=..., loss=..., mfu=...)``
  appends one row to a bounded in-memory series and, with
  ``FLAGS_metrics_dir`` set, one JSONL line to ``<dir>/metrics.jsonl``.
- **Prometheus textfile**: ``flush()`` rewrites ``<dir>/metrics.prom``
  (tmp file and rename, the node-exporter textfile contract) with the
  latest row as ``paddle_train_*`` gauges and the run's row counter.

hapi's ``TelemetryCallback`` feeds the bus from ``Model.fit``.
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..core.flags import flag
from ..testing.racecheck import shared_state as _shared_state

_LOG = logging.getLogger("paddle_tpu_torch.observability")

_SERIES_CAP = 65536


@_shared_state("_series", "_rows_total", "_providers",
               "_provider_errors")
class MetricsBus:
    def __init__(self):
        self._lock = threading.Lock()
        self._providers: Dict[str, Callable] = {}
        self._provider_errors: Dict[str, int] = {}
        self._series: "deque[dict]" = deque(maxlen=_SERIES_CAP)
        self._rows_total = 0
        # file IO under a lock of its own, so that a slow metrics.jsonl
        # write does not hold collect()/series() readers
        self._io_lock = threading.Lock()
        self._jsonl_path: Optional[str] = None
        self._jsonl = None

    # ------------------------------------------------------- providers --
    def register_provider(self, key: str, fn: Callable) -> None:
        """Register section `key`; registering it again replaces it."""
        if not callable(fn):
            raise TypeError(f"provider {key!r} must be callable")
        with self._lock:
            self._providers[key] = fn
            self._provider_errors.pop(key, None)

    def unregister_provider(self, key: str) -> None:
        with self._lock:
            self._providers.pop(key, None)
            self._provider_errors.pop(key, None)

    def providers(self) -> Dict[str, Callable]:
        with self._lock:
            return dict(self._providers)

    def collect(self) -> Dict[str, dict]:
        """{key: section} of every provider that returns a truthy
        section. A raising provider is skipped and logged once until it
        recovers."""
        out: Dict[str, dict] = {}
        for key, fn in self.providers().items():
            try:
                section = fn()
            except Exception as e:  # noqa: BLE001 — log and skip
                with self._lock:
                    n = self._provider_errors.get(key, 0)
                    self._provider_errors[key] = n + 1
                if n == 0:
                    _LOG.warning(
                        "summary provider %r raised and was skipped: %r",
                        key, e)
                continue
            with self._lock:
                self._provider_errors.pop(key, None)
            if section:
                out[key] = section
        return out

    def provider_error_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._provider_errors)

    # ----------------------------------------------------- step series --
    def record_step(self, **scalars) -> dict:
        """Append one per-step row (numbers; anything else as a string).
        With FLAGS_metrics_dir set the row also goes to
        <dir>/metrics.jsonl at once. A non-finite float is written as
        null, which strict JSON readers take."""
        row = {"t": round(time.time(), 6)}
        for k, v in scalars.items():
            if isinstance(v, bool) or v is None:
                row[k] = v
            elif isinstance(v, int):
                row[k] = v
            else:
                try:
                    f = float(v)
                except (TypeError, ValueError):
                    row[k] = str(v)
                    continue
                row[k] = round(f, 6) if math.isfinite(f) else None
        d = flag("metrics_dir")
        with self._lock:
            self._series.append(row)
            self._rows_total += 1
        if d:
            line = json.dumps(row)
            with self._io_lock:
                try:
                    f = self._open_jsonl_io_locked(d)
                    f.write(line + "\n")
                except OSError as e:
                    _LOG.warning("metrics.jsonl write failed: %r", e)
        return row

    def _open_jsonl_io_locked(self, d: str):
        path = os.path.join(os.path.expanduser(d), "metrics.jsonl")
        if self._jsonl is None or self._jsonl_path != path or \
                self._jsonl.closed:
            if self._jsonl is not None and not self._jsonl.closed:
                self._jsonl.close()
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._jsonl = open(path, "a")
            self._jsonl_path = path
        return self._jsonl

    def series(self) -> List[dict]:
        with self._lock:
            return list(self._series)

    def last(self) -> Optional[dict]:
        with self._lock:
            return self._series[-1] if self._series else None

    # ------------------------------------------------------ prometheus --
    def prometheus_text(self) -> str:
        """The latest step row as ``paddle_train_<field>`` gauges and the
        count of rows recorded."""
        last = self.last() or {}
        lines: List[str] = []
        lines.append("# HELP paddle_train_steps_total per-step rows "
                     "recorded on the metrics bus")
        lines.append("# TYPE paddle_train_steps_total counter")
        with self._lock:
            lines.append(f"paddle_train_steps_total {self._rows_total}")
        for k in sorted(last):
            if k == "t":
                continue
            v = last[k]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            name = "paddle_train_" + \
                "".join(c if c.isalnum() else "_" for c in k)
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {v}")
        return "\n".join(lines) + "\n"

    def flush(self) -> Optional[str]:
        """Flush the JSONL stream and rewrite the Prometheus textfile (by
        rename, so a scraper never reads a torn file). Returns its path,
        or None when FLAGS_metrics_dir is unset."""
        d = flag("metrics_dir")
        with self._io_lock:
            if self._jsonl is not None and not self._jsonl.closed:
                try:
                    self._jsonl.flush()
                except OSError:
                    pass
        if not d:
            return None
        d = os.path.expanduser(d)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "metrics.prom")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                f.write(self.prometheus_text())
            os.replace(tmp, path)
        except OSError as e:
            _LOG.warning("metrics.prom write failed: %r", e)
            return None
        return path

    def reset(self) -> None:
        """Drop the series and close the files; providers stay
        registered."""
        with self._lock:
            self._series.clear()
            self._rows_total = 0
            self._provider_errors.clear()
        with self._io_lock:
            if self._jsonl is not None and not self._jsonl.closed:
                self._jsonl.close()
            self._jsonl = None
            self._jsonl_path = None


BUS = MetricsBus()

register_provider = BUS.register_provider
unregister_provider = BUS.unregister_provider
collect = BUS.collect
record_step = BUS.record_step
series = BUS.series
flush = BUS.flush
prometheus_text = BUS.prometheus_text

__all__ = ["MetricsBus", "BUS", "register_provider", "unregister_provider",
           "collect", "record_step", "series", "flush", "prometheus_text"]
