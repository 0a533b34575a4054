"""Cross-thread span tracer (counterpart of
paddle_tpu/observability/trace.py).

A generation request crosses the client thread and a worker thread;
every span carries an explicit trace id (one per request) and a
span/parent id pair, and the worker hands the request's context as
`parent=` to `span()`/`emit_span()`. Completed spans are chrome-trace
`X` dicts in a bounded ring; `export()` writes them as one
Perfetto-loadable file.

Tracing is off unless FLAGS_trace_dir is set. Off, `span()` returns a
shared no-op handle and each hook costs one module-attribute check.

The reference names its file by the JAX process index; here the rank
comes from `torch.distributed` when a process group is initialised
(and the file is trace-<pid>.json otherwise).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import NamedTuple, Optional

from ..core.flags import flag
from . import exporter as _exporter


class TraceContext(NamedTuple):
    """Position in a trace: what a child span needs to attach."""

    trace_id: int
    span_id: int


_ENABLED = False
_DIR: Optional[str] = None
_LOCK = threading.Lock()
_SPANS: "deque[dict]" = deque(maxlen=262144)
_DROPPED = 0
_IDS = itertools.count(1)
_TLS = threading.local()


def _new_id() -> int:
    return next(_IDS)      # atomic under the GIL


def reconfigure(trace_dir: Optional[str]) -> None:
    """(Re)point the tracer at `trace_dir`; empty or None disables (and
    keeps what was recorded). Re-applies FLAGS_trace_buffer_spans."""
    global _ENABLED, _DIR, _SPANS
    _DIR = trace_dir or None
    _ENABLED = bool(trace_dir)
    if _ENABLED:
        cap = max(1024, int(flag("trace_buffer_spans")))
        with _LOCK:
            if _SPANS.maxlen != cap:
                _SPANS = deque(_SPANS, maxlen=cap)


reconfigure(flag("trace_dir"))


def enabled() -> bool:
    return _ENABLED


def _current_context() -> Optional[TraceContext]:
    """The calling thread's active trace position (None outside any
    span)."""
    return getattr(_TLS, "ctx", None)


def _record(event: dict) -> None:
    global _DROPPED
    with _LOCK:
        if len(_SPANS) == _SPANS.maxlen:
            _DROPPED += 1
        _SPANS.append(event)


def _event(name, cat, begin_ns, end_ns, args):
    return {"name": name, "ph": "X", "pid": os.getpid(),
            "tid": _exporter.stable_tid(), "ts": begin_ns / 1000.0,
            "dur": max((end_ns - begin_ns) / 1000.0, 0.001),
            "cat": cat, "args": args}


def emit_span(name: str, begin_ns: int, end_ns: int,
              parent: Optional[TraceContext] = None, cat: str = "span",
              args: Optional[dict] = None) -> Optional[TraceContext]:
    """Record one already-measured span under `parent` (else the
    thread's current context, else a fresh trace). Returns its context,
    None when tracing is off."""
    if not _ENABLED:
        return None
    ctx = parent if parent is not None else _current_context()
    trace_id = ctx.trace_id if ctx is not None else _new_id()
    span_id = _new_id()
    a = {"trace": trace_id, "span": span_id}
    if ctx is not None:
        a["parent"] = ctx.span_id
    if args:
        a.update(args)
    _record(_event(name, cat, begin_ns, end_ns, a))
    return TraceContext(trace_id, span_id)


class _NoopSpan:
    """Shared disabled-path handle."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kwargs):
        return self


_NOOP = _NoopSpan()


class Span:
    """Live span: opens on `__enter__` (becoming the thread's current
    context) and records itself on `__exit__`."""

    __slots__ = ("name", "cat", "args", "ctx", "_parent", "_prev",
                 "_begin_ns")

    def __init__(self, name: str, cat: str = "span",
                 args: Optional[dict] = None,
                 parent: Optional[TraceContext] = None):
        self.name = name
        self.cat = cat
        self.args = args
        self._parent = parent
        self.ctx: Optional[TraceContext] = None
        self._prev = None
        self._begin_ns = 0

    def set(self, **kwargs):
        """Attach or override args on a live span."""
        if self.args is None:
            self.args = {}
        self.args.update(kwargs)
        return self

    def __enter__(self):
        parent = self._parent if self._parent is not None \
            else getattr(_TLS, "ctx", None)
        trace_id = parent.trace_id if parent is not None else _new_id()
        self.ctx = TraceContext(trace_id, _new_id())
        self._parent = parent
        self._prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = self.ctx
        self._begin_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = time.perf_counter_ns()
        _TLS.ctx = self._prev
        a = {"trace": self.ctx.trace_id, "span": self.ctx.span_id}
        if self._parent is not None:
            a["parent"] = self._parent.span_id
        if exc_type is not None:
            a["error"] = exc_type.__name__
        if self.args:
            a.update(self.args)
        _record(_event(self.name, self.cat, self._begin_ns, end_ns, a))
        return False


def span(name: str, cat: str = "span", args: Optional[dict] = None,
         parent: Optional[TraceContext] = None):
    """Open a span (a context manager); the shared no-op handle when
    tracing is off."""
    if not _ENABLED:
        return _NOOP
    return Span(name, cat, args, parent)


_DONE = object()


def step_iter(it, name: str = "train.step", cat: str = "train",
              skip_first: int = 0):
    """Wrap a fit loop's iterator so that each iteration runs under one
    root `name` span, with the fetch of its item as a `train.data_wait`
    child; the loop body inherits the root's context. With tracing off
    items pass through with no span at all, and so do the first
    `skip_first` items (a resume's fast-forwarded prefix)."""
    it = iter(it)
    n = 0
    while True:
        if not _ENABLED or n < skip_first:
            item = next(it, _DONE)
            if item is _DONE:
                return
            n += 1
            yield item
            continue
        n += 1
        root = Span(name, cat, {"iter": n})
        root.__enter__()
        got_item = False
        try:
            t0 = time.perf_counter_ns()
            item = next(it, _DONE)
            if item is _DONE:
                return
            emit_span("train.data_wait", t0, time.perf_counter_ns(),
                      parent=root.ctx, cat=cat)
            got_item = True
            yield item
        finally:
            # on resume, on the consumer's break (close()) and on the
            # exhaustion probe; the probe's root is unwound unrecorded,
            # so no empty train.step closes an epoch
            if got_item:
                root.__exit__(None, None, None)
            else:
                _TLS.ctx = root._prev


def spans(trace_id: Optional[int] = None):
    """Snapshot of the recorded spans (optionally one trace's)."""
    with _LOCK:
        out = list(_SPANS)
    if trace_id is not None:
        out = [e for e in out if e.get("args", {}).get("trace") == trace_id]
    return out


def stats() -> dict:
    with _LOCK:
        return {"enabled": _ENABLED, "spans": len(_SPANS),
                "dropped": _DROPPED, "dir": _DIR or ""}


def _process_index() -> Optional[int]:
    """This process's rank when a torch.distributed group of more than
    one process is initialised, else None."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_rank() if dist.get_world_size() > 1 else None


def export(path: Optional[str] = None) -> str:
    """Write the recorded spans as one chrome-trace JSON. Default path:
    <FLAGS_trace_dir>/trace-<pid>.json, or trace-p<rank>-<pid>.json
    under a process group of several ranks."""
    pidx = _process_index()
    if path is None:
        name = f"trace-{os.getpid()}.json" if pidx is None else \
            f"trace-p{pidx}-{os.getpid()}.json"
        path = os.path.join(_DIR or ".", name)
    pname = "paddle_tpu_torch" if pidx is None else \
        f"paddle_tpu_torch rank{pidx}"
    return _exporter.write_chrome_trace(path, spans(), process_name=pname)


def reset() -> None:
    """Drop the recorded spans (the ring keeps its capacity)."""
    global _DROPPED
    with _LOCK:
        _SPANS.clear()
        _DROPPED = 0


__all__ = ["TraceContext", "Span", "span", "emit_span", "enabled",
           "reconfigure", "step_iter", "spans", "stats", "export", "reset"]
