"""The profiler's statistics engine (counterpart of
paddle_tpu/profiler/stats/__init__.py).

The reference hooks its own dispatcher; the port installs a
`torch.utils._python_dispatch.TorchDispatchMode` while a profiler
records (`install`) and removes it after (`uninstall`), so an idle
profiler costs nothing. Every aten op the mode sees, the backward's
under `loss.backward()` included, becomes an Operator event with its
host time, its FLOPs (flops.py), the module path it ran under and,
with profile_memory, its outputs' bytes as an allocation event. The
flash attention launches its kernels through ctypes, which no mode
sees: `attention_event` books each call as one
`scaled_dot_product_attention` event with the reference's count, and
the aten ops inside the call (the padding, the backward's delta, the
plain version's products on the CPU) are not booked apart.

From the events and the device trace's kernel totals it builds the
summary: per-op and per-module tables, the per-step FLOPs and MFU
series, the memory series, the kernel table, and the metrics bus's
sections (serving, fabric, autoscale, input_pipeline).
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import aggregator, memory
from .aggregator import (OpStat, build_table, fmt_bytes, fmt_flops,
                         kernel_totals, layer_stats, merge_device_totals,
                         op_stats)
from .flops import attention_flops, device_peak_flops, flops_for
from .memory import MemoryTracer

__all__ = [
    "install", "uninstall", "active", "add_flops",
    "attention_event", "device_peak_flops", "build_summary",
    "build_summary_dict", "op_stats", "layer_stats", "kernel_totals",
    "merge_device_totals", "OpStat", "MemoryTracer", "build_table",
    "fmt_flops", "fmt_bytes", "register_summary_provider",
    "unregister_summary_provider", "aggregator", "memory",
]


def register_summary_provider(key: str, fn) -> None:
    """A section of summary_dict(): the metrics bus's provider `key`."""
    from ...observability import bus as _bus

    _bus.register_provider(key, fn)


def unregister_summary_provider(key: str) -> None:
    from ...observability import bus as _bus

    _bus.unregister_provider(key)


class Session:
    """One recording window (Profiler.start .. stop)."""

    def __init__(self, profiler):
        self.profiler = profiler
        self.with_flops = bool(getattr(profiler, "with_flops", True))
        self.profile_memory = bool(getattr(profiler, "profile_memory",
                                           False))
        self.record_shapes = bool(getattr(profiler, "record_shapes", False))
        self.memory = MemoryTracer()
        if torch.cuda.is_available():
            self.memory.device = torch.device("cuda",
                                              torch.cuda.current_device())
        self.step_flops = 0

    def add_step_flops(self, n: int):
        self.step_flops += int(n)


_SESSION: Optional[Session] = None
_MODE: Optional["_OpMode"] = None
# per thread: inside an op booked as one event (attention_event)
_TLS = threading.local()


def active() -> Optional[Session]:
    return _SESSION


def add_flops(n: int):
    """Book `n` FLOPs into the current step; nothing when idle."""
    s = _SESSION
    if s is not None:
        s.add_step_flops(n)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def _book(name, begin_ns, end_ns, invals, outvals, kwargs, flops=None):
    s = _SESSION
    if s is None:
        return
    from ... import profiler as _prof

    ev_args = {"layer": _prof.current_layer()}
    if s.with_flops:
        f = flops_for(name, invals, outvals, kwargs) if flops is None \
            else int(flops)
        ev_args["flops"] = f
        s.step_flops += f
    if s.record_shapes:
        ev_args["shapes"] = [tuple(int(d) for d in v.shape) for v in invals]
    if s.profile_memory:
        nbytes = sum(v.numel() * v.element_size() for v in outvals)
        if nbytes:
            s.memory.on_alloc(name, nbytes)
    _prof._emit_event(name, begin_ns, end_ns, "Operator", ev_args)


class _OpMode(TorchDispatchMode):
    """Books every aten op as an Operator event (see the module's doc)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(_TLS, "opaque", 0):
            return func(*args, **kwargs)
        t0 = time.perf_counter_ns()
        out = func(*args, **kwargs)
        t1 = time.perf_counter_ns()
        _book(func._overloadpacket.__name__, t0, t1, _tensors(args),
              _tensors(out), kwargs)
        return out


@contextmanager
def opaque():
    """Ops run inside are not booked (the attention's own work)."""
    _TLS.opaque = getattr(_TLS, "opaque", 0) + 1
    try:
        yield
    finally:
        _TLS.opaque -= 1


@contextmanager
def attention_event(q, k, causal: bool):
    """Book the call inside as one `scaled_dot_product_attention` event
    with the reference's FLOPs for q, k [B, L, H, D]; its own ops are
    not booked."""
    t0 = time.perf_counter_ns()
    with opaque():
        yield
    _book("scaled_dot_product_attention", t0, time.perf_counter_ns(),
          [q, k], [], {}, flops=attention_flops(q.shape, k.shape, causal))


def install(profiler, session: Optional[Session] = None) -> Session:
    """Begin recording into `session` (None: a new one): the dispatch
    mode goes on the calling thread's mode stack (a forward's backward,
    run by autograd, sees it too)."""
    global _SESSION, _MODE
    sess = session if session is not None else Session(profiler)
    _SESSION = sess
    if _MODE is None:
        _MODE = _OpMode()
        _MODE.__enter__()
    return sess


def uninstall(session: Session):
    global _SESSION, _MODE
    if _SESSION is not session:
        return
    _SESSION = None
    if _MODE is not None:
        _MODE.__exit__(None, None, None)
        _MODE = None


def mode_installed() -> bool:
    return _MODE is not None


# ------------------------------------------------------------- summaries --
def _ms(us: float) -> str:
    return f"{us / 1000.0:.3f}"


def _mfu_str(flops: int, seconds: float, peak: float) -> str:
    if not flops or seconds <= 0:
        return "-"
    return f"{flops / seconds / peak * 100:.2f}%"


def _kernels(prof) -> dict:
    return dict(getattr(prof, "kernels", None) or {})


def build_summary(prof, sorted_by=None, time_unit="ms") -> str:
    """Every summary section of a (stopped or live) Profiler, rendered."""
    events = prof.events()
    ops = op_stats(events)
    kernels = _kernels(prof)
    merge_device_totals(ops, {k: v["us"] for k, v in kernels.items()})
    peak = device_peak_flops()
    sections = [
        f"Profiler statistics (time unit: ms; MFU basis "
        f"{fmt_flops(peak)}FLOP/s)"
    ]

    rows = []
    for st in sorted(ops.values(), key=lambda s: -s.total):
        host_s = st.total / 1e6
        dev_s = st.device_total / 1e6
        rows.append([
            st.name, st.calls, _ms(st.total), _ms(st.avg), _ms(st.max),
            _ms(st.min if st.calls else 0.0), _ms(st.device_total),
            fmt_flops(st.flops) if st.flops else "-",
            _mfu_str(st.flops, dev_s or host_s, peak),
        ])
    sections.append(build_table(
        "Operator Summary",
        ["Name", "Calls", "Total", "Avg", "Max", "Min", "Device", "FLOPs",
         "MFU"], rows))

    from ...observability import bus as _bus

    for key, section in _bus.collect().items():
        prows = [[k, v] for k, v in section.items()
                 if not isinstance(v, (dict, list))]
        sections.append(build_table(
            f"{key.title()} Summary", ["Key", "Value"], prows))

    layers = layer_stats(events)
    lrows = []
    for st in sorted(layers.values(), key=lambda s: s.name):
        lrows.append([
            st.name, st.calls, _ms(st.total), _ms(st.avg),
            fmt_flops(st.flops) if st.flops else "-",
            _mfu_str(st.flops, st.total / 1e6, peak),
        ])
    sections.append(build_table(
        "Layer Summary (module name stack)",
        ["Layer", "Calls", "Total", "Avg", "FLOPs", "MFU"], lrows))

    srows = []
    for r in getattr(prof, "step_records", []):
        srows.append([
            r["step"], f"{r['time_ms']:.3f}", fmt_flops(r["flops"]),
            fmt_flops(r["flops_per_sec"]) + "/s",
            f"{r['mfu'] * 100:.2f}%",
        ])
    sections.append(build_table(
        "Step Summary",
        ["Step", "Time(ms)", "FLOPs", "FLOP/s", "MFU"], srows))

    sess = getattr(prof, "_session", None)
    if sess is not None and sess.memory.steps:
        mrows = [[r["step"], r["live_arrays"], fmt_bytes(r["live_bytes"]),
                  fmt_bytes(r["bytes_in_use"]), fmt_bytes(r["peak_bytes"]),
                  r["alloc_events"]] for r in sess.memory.steps]
        sections.append(build_table(
            "Memory Summary (per step)",
            ["Step", "LiveArrays", "Live", "InUse", "Peak", "AllocEvents"],
            mrows))

    if kernels:
        krows = [[k, v["count"], f"{v['us'] / 1000.0:.3f}"] for k, v in
                 sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:15]]
        sections.append(build_table(
            "Kernel Summary (device trace)",
            ["Kernel", "Launches", "Total(ms)"], krows))
    return "\n\n".join(sections)


def build_summary_dict(prof, top_ops: int = 8,
                       top_kernels: int = 15) -> dict:
    """Structured digest: the step series' MFU, the top ops, the kernel
    table (the top kernels by device time, and every flash kernel), the
    memory and the bus's sections."""
    events = prof.events()
    ops = op_stats(events)
    kernels = _kernels(prof)
    merge_device_totals(ops, {k: v["us"] for k, v in kernels.items()})
    peak = device_peak_flops()
    steps = list(getattr(prof, "step_records", []))
    out = {"device_peak_flops": peak}
    if steps:
        out["steps"] = len(steps)
        out["avg_step_time_ms"] = round(
            sum(r["time_ms"] for r in steps) / len(steps), 3)
        out["flops_per_step"] = int(max(r["flops"] for r in steps))
        out["avg_mfu"] = round(sum(r["mfu"] for r in steps) / len(steps), 4)
        out["step_mfu"] = [round(r["mfu"], 4) for r in steps]
    out["top_ops"] = [
        {"name": st.name, "calls": st.calls,
         "total_ms": round(st.total / 1000.0, 3),
         "device_ms": round(st.device_total / 1000.0, 3),
         "flops": int(st.flops)}
        for st in sorted(ops.values(), key=lambda s: -s.total)[:top_ops]
    ]
    if kernels:
        ranked = sorted(kernels.items(), key=lambda kv: -kv[1]["us"])
        keep = ranked[:top_kernels] + [
            kv for kv in ranked[top_kernels:]
            if aggregator.kernel_op(kv[0]) is not None]
        out["device_kernels"] = [
            {"name": k, "launches": v["count"],
             "ms": round(v["us"] / 1000.0, 3)} for k, v in keep]
        out["device_ms"] = round(sum(v["us"] for v in kernels.values())
                                 / 1000.0, 3)
    sess = getattr(prof, "_session", None)
    if sess is not None and sess.memory.steps:
        last = sess.memory.steps[-1]
        out["memory"] = {
            "peak_bytes": max(r["peak_bytes"] for r in sess.memory.steps),
            "live_bytes": last["live_bytes"],
            "bytes_in_use": last["bytes_in_use"],
            "alloc_events": last["alloc_events"],
        }
    from ...observability import bus as _bus

    # collect() logs and skips a provider that raises
    out.update(_bus.collect())
    return out
