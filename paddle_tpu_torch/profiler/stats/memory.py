"""Memory tracing (counterpart of paddle_tpu/profiler/stats/memory.py):
an allocation event stream and a per-step live and peak series.

On a CUDA device each step reads the caching allocator:
`torch.cuda.memory_allocated` (bytes in use), `max_memory_allocated`
(the peak, reset when the profiler starts) and the allocator's count of
live blocks. On the CPU, as the reference off the TPU, the numbers are
the bytes of the op outputs the profiler saw (each op output an
allocation event): bytes in use are the step's, the peak their running
maximum.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch


class MemoryTracer:
    """Collects allocation events and a per-step memory series."""

    def __init__(self):
        self.alloc_events: List[dict] = []
        self.steps: List[dict] = []
        self._peak_live = 0
        self._alloc_bytes = 0
        self._step_mark = 0
        self.device: Optional[torch.device] = None

    # ------------------------------------------------------ event stream
    def on_alloc(self, kind: str, nbytes: int, place=None):
        """One allocation event (op output, user record_memory_event)."""
        self.alloc_events.append({
            "ts": time.perf_counter_ns() / 1000.0,
            "kind": kind,
            "nbytes": int(nbytes),
            "place": str(place) if place is not None else None,
        })
        self._alloc_bytes += int(nbytes)

    # ------------------------------------------------------ step series
    def snapshot(self, step: int) -> dict:
        """Append one per-step record; peak_bytes never falls."""
        step_bytes = self._alloc_bytes - self._step_mark
        self._step_mark = self._alloc_bytes
        dev = self.device
        if dev is not None and dev.type == "cuda":
            in_use = torch.cuda.memory_allocated(dev)
            peak = torch.cuda.max_memory_allocated(dev)
            live_n = int(torch.cuda.memory_stats(dev).get(
                "active.all.current", 0))
            live_b = in_use
        else:
            in_use = live_b = step_bytes
            live_n = 0
            peak = None
        self._peak_live = max(self._peak_live, live_b)
        rec = {
            "step": int(step),
            "bytes_in_use": int(in_use),
            "peak_bytes": int(self._peak_live if peak is None else peak),
            "live_arrays": int(live_n),
            "live_bytes": int(live_b),
            "alloc_events": len(self.alloc_events),
            "alloc_bytes": int(self._alloc_bytes),
        }
        self.steps.append(rec)
        return rec
