"""Prefetch stages: the host worker pool and the device double buffer
(counterpart of paddle_tpu/io/pipeline/prefetch.py).

HostPrefetcher is the decode side, the DataLoader's in-order futures
over a thread pool: batches decode `workers` wide while the consumer
takes them in submission order, and a worker's exception cancels the
queue and is raised at once, not after every batch submitted before it.

DevicePrefetcher is the copy to the device, from a thread of its own,
keeping `depth` batches resident there. On a CUDA device each batch is
copied into pinned host memory and from there to the card with
`non_blocking=True` on a `torch.cuda.Stream` that the prefetcher owns;
an event recorded after the copies travels with the batch. The
consumer's `next()` makes its current stream wait on that event and
marks every tensor with `record_stream`, so the caching allocator does
not give a batch's memory to a later copy while a step still reads it.
With depth 2, step N+1's copy runs under step N's kernels and `next()`
is a queue pop. On the CPU it is a plain copy.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List

import numpy as np
import torch

from ...observability import trace as _tr


class HostPrefetcher:
    """In-order prefetch of `fetch(batch_indices)` over a thread pool."""

    def __init__(self, fetch: Callable, batches: Iterator[List[int]],
                 workers: int, prefetch_factor: int = 2, metrics=None):
        self._fetch = self._traced(fetch)
        self._batches = iter(batches)
        self._pool = ThreadPoolExecutor(max_workers=max(1, workers),
                                        thread_name_prefix="pipeline-decode")
        self._pending: list = []
        self._metrics = metrics
        self._closed = False
        depth = max(1, workers) * max(1, prefetch_factor)
        for indices in _islice(self._batches, depth):
            self._pending.append(self._pool.submit(self._fetch, indices))

    @staticmethod
    def _traced(fetch: Callable) -> Callable:
        """One `pipeline.decode` span a batch on the pool's threads (one
        flag check when tracing is off)."""
        def run(indices):
            with _tr.span("pipeline.decode", "pipeline",
                          {"batch_size": len(indices)}):
                return fetch(indices)

        return run

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed or not self._pending:
            self.close()
            raise StopIteration
        # any finished future's exception is raised now, not when its
        # turn comes, and the queue is cancelled
        for f in self._pending:
            if f.done() and f.exception() is not None:
                exc = f.exception()
                self.close()
                raise exc
        fut = self._pending.pop(0)
        nxt = next(self._batches, None)
        if nxt is not None:
            self._pending.append(self._pool.submit(self._fetch, nxt))
        if self._metrics is not None:
            self._metrics.host_queue_depth = len(self._pending)
        try:
            return fut.result()
        except BaseException:
            self.close()
            raise

    def close(self):
        if self._closed:
            return
        self._closed = True
        for f in self._pending:
            f.cancel()
        self._pending = []
        self._pool.shutdown(wait=False, cancel_futures=True)


class _Sentinel:
    pass


_DONE = _Sentinel()


def _leaves(batch):
    if isinstance(batch, torch.Tensor):
        return [batch]
    if isinstance(batch, dict):
        return [t for v in batch.values() for t in _leaves(v)]
    if isinstance(batch, (list, tuple)):
        return [t for v in batch for t in _leaves(v)]
    return []


def _map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    return fn(batch)


def _host_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


class DevicePrefetcher:
    """Copies host batches to `device` from a background thread, `depth`
    of them ahead of the consumer.

    `src_next()` gives host batches (numpy arrays or CPU tensors, in
    tuples, lists or dicts). Errors and StopIteration reach the consumer
    through the queue. On a CUDA device every copy runs on the
    prefetcher's stream (see the module's doc); a failed copy raises in
    the consumer, never falling back to a synchronous one."""

    def __init__(self, src_next: Callable, depth: int = 2, device=None,
                 metrics=None):
        from ... import resolve_device

        self._src_next = src_next
        self._device = resolve_device(device)
        self._metrics = metrics
        self._stream = None
        if self._device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self._device)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        # the copy's spans have no parent: the step that takes the batch
        # opens its own trace (train.data_wait)
        self._thread = threading.Thread(target=self._run,
                                        name="device-prefetch",
                                        daemon=True)
        self._thread.start()

    # ----------------------------------------------------------- worker --
    def _put_device(self, batch):
        """(the batch on the device, the CUDA event after its copies or
        None). The copy's time, pinning included, goes to the metrics; on
        the card the thread waits for its own event, so it is the time
        until the batch is there."""
        t0 = time.perf_counter()
        if self._stream is None:
            out = _map(lambda v: _host_tensor(v).to(self._device, copy=True),
                       batch)
            event = None
        else:
            with torch.cuda.stream(self._stream):
                out = _map(lambda v: _host_tensor(v).pin_memory().to(
                    self._device, non_blocking=True), batch)
                event = torch.cuda.Event()
                event.record(self._stream)
            event.synchronize()
        if self._metrics is not None:
            self._metrics.on_put(time.perf_counter() - t0)
        return out, event

    def _run(self):
        while not self._stop.is_set():
            try:
                host = self._src_next()
            except StopIteration:
                self._enqueue(_DONE)
                return
            except BaseException as e:  # noqa: BLE001 — for the consumer
                self._enqueue(e)
                return
            try:
                with _tr.span("pipeline.device_put", "pipeline"):
                    item = self._put_device(host)
            except BaseException as e:  # noqa: BLE001
                self._enqueue(e)
                return
            if not self._enqueue(item):
                return

    def _enqueue(self, item) -> bool:
        """Put that gives up once the consumer is gone (close() sets the
        stop flag), so a full queue never holds the thread for good."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    # --------------------------------------------------------- consumer --
    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if self._metrics is not None:
            self._metrics.device_queue_depth = self._q.qsize()
        if item is _DONE:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        out, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in _leaves(out):
                t.record_stream(stream)
        return out

    def close(self):
        self._stop.set()
        # free a producer waiting on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        try:
            self._stop.set()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


def _islice(it, n):
    out = []
    for _ in range(n):
        nxt = next(it, None)
        if nxt is None:
            break
        out.append(nxt)
    return out


__all__ = ["HostPrefetcher", "DevicePrefetcher"]
