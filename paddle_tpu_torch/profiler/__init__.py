"""The profiler (counterpart of paddle_tpu/profiler/__init__.py).

Host events are RecordEvent spans, one event an aten op (stats/: a
TorchDispatchMode while recording), one a module forward, named by the
module name stack (global module hooks while recording) and one a step.
The device trace is torch.profiler's, with CPU and CUDA activities
(CUPTI), taken over the recorded steps unless `timer_only`: its CUDA
kernels' totals by name (the hand-written ones under their CUDA names)
fill the op table's device column and the kernel table. The scheduler
(`make_scheduler`) decides which steps record. Chrome-trace export of
the host events is built in.
"""
from __future__ import annotations

import json
import os
import threading
import time
import weakref
from contextlib import contextmanager
from enum import Enum
from typing import Optional

import torch

from ..observability import exporter as _exporter


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    TPU = 2
    CUSTOM_DEVICE = 3


class TracerEventType(Enum):
    Operator = 0
    Dataloader = 1
    ProfileStep = 2
    Forward = 3
    Backward = 4
    Optimization = 5
    Communication = 6
    PythonOp = 7
    UserDefined = 8


_events = []
_events_lock = threading.Lock()
_enabled = False        # a profiler is recording this step
_RUNNING = None         # the profiler between its start() and stop()


def running():
    """The Profiler started and not stopped, or None."""
    return _RUNNING


def _emit_event(name, begin_ns, end_ns, cat="UserDefined", args=None):
    """Append one chrome-trace span (RecordEvent.end, the stats engine's
    op events, the module hooks), while recording. The tid is the
    exporter's small stable one, which also names the thread."""
    if not _enabled:
        return
    e = {
        "name": name, "ph": "X", "pid": os.getpid(),
        "tid": _exporter.stable_tid(),
        "ts": begin_ns / 1000.0,
        "dur": (end_ns - begin_ns) / 1000.0,
        "cat": cat,
    }
    if args:
        e["args"] = args
    with _events_lock:
        _events.append(e)


def live_events():
    """Snapshot of the process-wide host-event buffer (the current
    recording; a stopped Profiler keeps its own, Profiler.events)."""
    with _events_lock:
        return list(_events)


class RecordEvent:
    """A user span: an event of `event_type` from begin() to end()."""

    def __init__(self, name: str,
                 event_type: TracerEventType = TracerEventType.UserDefined,
                 args: Optional[dict] = None):
        self.name = name
        self.event_type = event_type
        self.args = args
        self._begin = None

    def begin(self):
        self._begin = time.perf_counter_ns()

    def end(self):
        if self._begin is None or not _enabled:
            return
        _emit_event(self.name, self._begin, time.perf_counter_ns(),
                    self.event_type.name, self.args)

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


# ------------------------------------------------------- layer name stack
# Thread-local module name stack: while a profiler records, every module
# forward enters layer_scope(<its attribute name>) through global module
# hooks (`_install_module_hooks`), and each op event carries
# current_layer().
_layer_stack = threading.local()


def _stack():
    s = getattr(_layer_stack, "s", None)
    if s is None:
        s = _layer_stack.s = []
    return s


def current_layer() -> str:
    """Dotted name-stack path of the innermost running module forward
    ('' outside any)."""
    return ".".join(_stack())


@contextmanager
def layer_scope(name: str):
    """Push `name` on the layer name stack and record the span as a
    Forward event named with the full dotted path."""
    s = _stack()
    s.append(name)
    t0 = time.perf_counter_ns()
    path = ".".join(s)
    try:
        yield
    finally:
        _emit_event(path, t0, time.perf_counter_ns(),
                    TracerEventType.Forward.name)
        s.pop()


# module -> its segment of the name stack: the attribute name in its
# parent (a ModuleList's children "blocks.0", ..., since a ModuleList runs
# no forward of its own), a root module its class name in lower case
_NAMES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_OPEN = threading.local()
_HOOKS: list = []


def _name_children(module):
    for name, child in module.named_children():
        if isinstance(child, torch.nn.ModuleList):
            for k, sub in child.named_children():
                _NAMES[sub] = f"{name}.{k}"
        _NAMES.setdefault(child, name)


def _pre_hook(module, args):
    _name_children(module)
    name = _NAMES.get(module) or type(module).__name__.lower()
    s = _stack()
    s.append(name)
    opened = getattr(_OPEN, "s", None)
    if opened is None:
        opened = _OPEN.s = []
    opened.append((module, time.perf_counter_ns(), ".".join(s)))


def _post_hook(module, args, output):
    opened = getattr(_OPEN, "s", None)
    if not opened or opened[-1][0] is not module:
        return
    _, t0, path = opened.pop()
    _emit_event(path, t0, time.perf_counter_ns(),
                TracerEventType.Forward.name)
    _stack().pop()


def _install_module_hooks():
    if _HOOKS:
        return
    from torch.nn.modules import module as _m

    _HOOKS.append(_m.register_module_forward_pre_hook(_pre_hook))
    _HOOKS.append(_m.register_module_forward_hook(_post_hook,
                                                  always_call=True))


def _remove_module_hooks():
    while _HOOKS:
        _HOOKS.pop().remove()


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """The state of step `step`: CLOSED for `skip_first` steps, then
    cycles of `closed` CLOSED, `ready` READY and `record` RECORD steps
    (the reference's: `repeat` is not read, the cycles go on)."""
    def scheduler(step):
        s = step - skip_first
        if s < 0:
            return ProfilerState.CLOSED
        cycle = closed + ready + record
        pos = s % cycle if cycle else 0
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        return ProfilerState.RECORD
    return scheduler


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        path = os.path.join(dir_name,
                            f"{worker_name or 'worker'}.chrometrace.json")
        prof.export(path)
    return handler


class Profiler:
    """Records op events (time, FLOPs, module path), module and step
    spans, a per-step FLOPs and MFU series, a per-step memory series
    (profile_memory) and, unless `timer_only`, torch.profiler's device
    trace over the recorded steps.

    `scheduler(step)` (make_scheduler) gives each step's state; only
    RECORD steps are recorded (without a scheduler every step is). A
    recorded step's window runs from the step() that opened it to the
    one that closes it. The device trace of a window is prepared on the
    READY step before it; a window with no READY step (no scheduler, or
    one that opens at step 0) prepares and starts it together, and its
    first kernels can be missing from it."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False, custom_device_types=None):
        self.on_trace_ready = on_trace_ready
        self._scheduler = scheduler
        self._step = 0
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self.with_flops = with_flops
        self._session = None
        self.step_records = []  # per step {"step","time_ms","flops","mfu"}
        self._step_mark_ns = None
        self._step_flops_mark = 0
        self._captured = None   # the events this profiler recorded
        self._recording = False
        self._torch_prof = None
        self.kernels = {}       # kernel name -> {"us", "count"}

    def _state(self, step):
        if self._scheduler is None:
            return ProfilerState.RECORD
        return self._scheduler(step)

    def _record(self, on: bool):
        """Enter or leave a recording window: the op mode, the module
        hooks and the device trace."""
        global _enabled
        if on == self._recording:
            return
        self._recording = on
        _enabled = on
        from . import stats as _stats

        if on:
            # a later window carries on the same session's FLOPs and memory
            self._session = _stats.install(self, self._session)
            _install_module_hooks()
            if not self.timer_only and torch.cuda.is_available():
                self._prepare_device_trace()
                self._torch_prof.start_trace()
        else:
            _remove_module_hooks()
            _stats.uninstall(self._session)
            if self._torch_prof is not None:
                torch.cuda.synchronize()
                self._torch_prof.stop()
                for k, v in _stats.kernel_totals(
                        self._torch_prof.key_averages()).items():
                    mine = self.kernels.setdefault(k, {"us": 0.0,
                                                       "count": 0})
                    mine["us"] += v["us"]
                    mine["count"] += v["count"]
                self._torch_prof = None

    def _prepare_device_trace(self):
        """Start torch.profiler's collection (CUPTI) without recording,
        as torch.profiler's own warmup does: a READY step prepares the
        next window's trace, since kernels launched right after a cold
        start can be missing from it."""
        if self._torch_prof is None:
            from torch.profiler import ProfilerActivity, profile

            self._torch_prof = profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._torch_prof.prepare_trace()

    def _next_state(self):
        """Open or close the recording for the step about to run, and
        prepare the device trace a step ahead of a window."""
        state = self._state(self._step)
        self._record(state in (ProfilerState.RECORD,
                               ProfilerState.RECORD_AND_RETURN))
        if (state == ProfilerState.READY and not self.timer_only
                and torch.cuda.is_available()):
            self._prepare_device_trace()

    def start(self):
        global _events, _RUNNING
        _RUNNING = self
        with _events_lock:
            _events = []
        self.step_records = []
        self._captured = None
        self.kernels = {}
        self._session = None
        if self.profile_memory and torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        self._step_mark_ns = time.perf_counter_ns()
        self._step_flops_mark = 0
        self._next_state()

    def step(self, num_samples=None):
        """Close the current step's window: a recorded step gets its
        record (time, the FLOPs booked in it, MFU) and, with
        profile_memory, a memory snapshot. Then the next step's state
        opens or closes the recording."""
        now = time.perf_counter_ns()
        if self._recording:
            from . import stats as _stats

            t0 = self._step_mark_ns or now
            dt_s = max((now - t0) / 1e9, 1e-12)
            flops = self._session.step_flops - self._step_flops_mark
            rec = {
                "step": self._step + 1,
                "time_ms": (now - t0) / 1e6,
                "flops": int(flops),
                "flops_per_sec": flops / dt_s,
                "mfu": flops / dt_s / _stats.device_peak_flops(),
            }
            if num_samples is not None:
                rec["num_samples"] = num_samples
            self.step_records.append(rec)
            _emit_event(f"ProfileStep#{self._step + 1}", t0, now,
                        TracerEventType.ProfileStep.name)
            if self.profile_memory:
                self._session.memory.snapshot(self._step + 1)
        self._step += 1
        self._next_state()
        if self._session is not None:
            self._step_flops_mark = self._session.step_flops
        self._step_mark_ns = time.perf_counter_ns()

    def stop(self):
        global _enabled, _RUNNING
        self._record(False)
        if self._torch_prof is not None:
            # prepared for a window that never opened: start and stop it
            # empty, as torch.profiler does after a warmup with no record
            self._torch_prof.start_trace()
            self._torch_prof.stop()
            self._torch_prof = None
        _enabled = False
        if _RUNNING is self:
            _RUNNING = None
        # keep this profiler's events: the buffer is process-wide and the
        # next start() clears it
        with _events_lock:
            self._captured = list(_events)
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def export(self, path: str, format: str = "json"):
        """Write the host events as chrome-trace JSON (thread and process
        name metadata, stable tids; observability.exporter's format)."""
        return _exporter.write_chrome_trace(path, self.events())

    def events(self):
        """The recorded host events (chrome-trace dicts): the live buffer
        while recording, this profiler's own after stop()."""
        if self._captured is not None:
            return list(self._captured)
        with _events_lock:
            return list(_events)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms", views=None):
        """The statistics tables (ops, modules, steps, memory, kernels and
        the bus's sections); prints and returns the text."""
        from . import stats as _stats

        out = _stats.build_summary(self, sorted_by=sorted_by,
                                   time_unit=time_unit)
        print(out)
        return out

    def summary_dict(self, top_ops: int = 8):
        """The summary as a dict (stats.build_summary_dict)."""
        from . import stats as _stats

        return _stats.build_summary_dict(self, top_ops=top_ops)


@contextmanager
def profiler_guard(**kwargs):
    p = Profiler(**kwargs)
    p.start()
    try:
        yield p
    finally:
        p.stop()


def load_profiler_result(path):
    if path.endswith(".pb"):
        import pickle

        with open(path, "rb") as f:
            return pickle.load(f)
    with open(path) as f:
        return json.load(f)


class SortedKeys(Enum):
    """Summary-table sort keys."""

    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


class SummaryView(Enum):
    """Summary views."""

    DeviceView = 0
    OverView = 1
    ModelView = 2
    DistributedView = 3
    KernelView = 4
    OperatorView = 5
    MemoryView = 6
    MemoryManipulationView = 7
    UDFView = 8


def export_protobuf(dir_name: str, worker_name: Optional[str] = None):
    """on_trace_ready handler writing a pickled event dump; read it with
    load_profiler_result."""
    import pickle
    import time as _time

    def handler(prof):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"worker_{os.getpid()}"
        path = os.path.join(dir_name, f"{name}_{int(_time.time())}.pb")
        with _events_lock:
            data = {"traceEvents": list(_events)}
        with open(path, "wb") as f:
            pickle.dump(data, f)
        return path

    return handler


__all__ = ["ProfilerState", "ProfilerTarget", "TracerEventType",
           "RecordEvent", "layer_scope", "current_layer", "make_scheduler",
           "export_chrome_tracing", "export_protobuf", "Profiler",
           "profiler_guard", "load_profiler_result", "SortedKeys",
           "SummaryView", "live_events", "running"]
