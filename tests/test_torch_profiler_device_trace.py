"""When the port's Profiler drives torch.profiler's device trace, on the
CPU with the card and torch.profiler faked: a scheduled window's trace
is prepared (CUPTI started, nothing recorded) on the READY step before
it and started on its first RECORD step, so the window's first kernels
are not lost to a cold start; a window that never opens after a READY
step is started and stopped empty; without a READY step (no scheduler,
or a window at step 0) the trace is prepared and started together."""
import pytest
import torch

from paddle_tpu_torch import profiler as prof


class _FakeTrace:
    """torch.profiler.profile's calls, in order, in `log`."""

    log = []

    def __init__(self, activities=None):
        self.log.append("new")

    def prepare_trace(self):
        self.log.append("prepare")

    def start_trace(self):
        self.log.append("start")

    def stop(self):
        self.log.append("stop")

    def key_averages(self):
        return []


@pytest.fixture
def trace(monkeypatch):
    import torch.profiler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.profiler, "profile", _FakeTrace)
    _FakeTrace.log = []
    yield _FakeTrace.log
    assert not prof.running()


def test_a_window_is_prepared_on_its_ready_step(trace):
    p = prof.Profiler(scheduler=prof.make_scheduler(closed=1, ready=1,
                                                    record=1))
    p.start()                       # step 0: CLOSED
    assert trace == []
    p.step()                        # step 1: READY
    assert trace == ["new", "prepare"]
    p.step()                        # step 2: RECORD
    assert trace == ["new", "prepare", "start"]
    p.step()                        # step 3: CLOSED
    assert trace == ["new", "prepare", "start", "stop"]
    p.step()                        # step 4: READY, the next window's
    assert trace[4:] == ["new", "prepare"]
    p.step()                        # step 5: RECORD
    p.stop()
    assert trace[4:] == ["new", "prepare", "start", "stop"]


def test_a_prepared_window_that_never_opens_is_stopped_empty(trace):
    p = prof.Profiler(scheduler=prof.make_scheduler(closed=0, ready=2,
                                                    record=1))
    p.start()                       # step 0: READY
    p.step()                        # step 1: READY, already prepared
    assert trace == ["new", "prepare"]
    p.stop()
    assert trace == ["new", "prepare", "start", "stop"]


@pytest.mark.parametrize("scheduler", [
    None, prof.make_scheduler(closed=0, ready=0, record=2)],
    ids=["no_scheduler", "window_at_step_0"])
def test_a_window_with_no_ready_step_starts_at_once(trace, scheduler):
    p = prof.Profiler(scheduler=scheduler)
    p.start()
    assert trace == ["new", "prepare", "start"]
    p.step()
    p.stop()
    assert trace == ["new", "prepare", "start", "stop"]


def test_timer_only_takes_no_device_trace(trace):
    p = prof.Profiler(scheduler=prof.make_scheduler(closed=0, ready=1,
                                                    record=1),
                      timer_only=True)
    p.start()
    p.step()
    p.step()
    p.stop()
    assert trace == []
