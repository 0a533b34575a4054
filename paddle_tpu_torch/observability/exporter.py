"""Chrome-trace / Perfetto export (counterpart of
paddle_tpu/observability/exporter.py, without its validator).

`stable_tid()` maps each thread to a small integer in first-seen order
and remembers its name; `write_chrome_trace` writes the events with
process and thread metadata rows, through `json.dump`, so a span name
with quotes cannot break the file.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Tuple

_TID_LOCK = threading.Lock()
_TID_NAMES: Dict[int, str] = {}     # stable tid -> thread name
_TID_COUNT = 0
# the tid lives in a thread-local (it dies with its thread), not in a
# dict keyed by thread ident, which the OS reuses
_TID_TLS = threading.local()


def stable_tid() -> int:
    """Small stable integer id for the calling thread (first-seen
    order); records the thread's current name."""
    tid = getattr(_TID_TLS, "tid", None)
    if tid is not None:
        return tid
    global _TID_COUNT
    with _TID_LOCK:
        _TID_COUNT += 1
        tid = _TID_COUNT
        _TID_NAMES[tid] = threading.current_thread().name
    _TID_TLS.tid = tid
    return tid


def thread_names() -> Dict[int, str]:
    with _TID_LOCK:
        return dict(_TID_NAMES)


def metadata_events(events: List[dict],
                    process_name: str = "paddle_tpu_torch") -> List[dict]:
    """`M`-phase process and thread rows for every (pid, tid) in
    `events`."""
    names = thread_names()
    pids = sorted({e["pid"] for e in events if "pid" in e})
    pairs: List[Tuple[int, int]] = sorted({
        (e["pid"], e["tid"]) for e in events
        if e.get("ph") != "M" and "pid" in e and "tid" in e})
    out: List[dict] = []
    for pid in pids:
        out.append({"name": "process_name", "ph": "M", "pid": pid,
                    "tid": 0, "args": {"name": f"{process_name} {pid}"}})
    for pid, tid in pairs:
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid,
                    "args": {"name": names.get(tid, f"thread {tid}")}})
        out.append({"name": "thread_sort_index", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"sort_index": tid}})
    return out


def write_chrome_trace(path: str, events: List[dict],
                       process_name: str = "paddle_tpu_torch") -> str:
    """Write `events` (chrome-trace span dicts, sorted by time after the
    metadata rows) to `path`; returns `path`."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    spans = sorted((e for e in events if e.get("ph") != "M"),
                   key=lambda e: e.get("ts", 0.0))
    obj = {"traceEvents": metadata_events(events, process_name) + spans,
           "displayTimeUnit": "ms"}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)
    return path


__all__ = ["stable_tid", "thread_names", "metadata_events",
           "write_chrome_trace"]
