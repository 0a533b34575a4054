"""Dynamic-batching serving engine over the Predictor (counterpart of
paddle_tpu/inference/serving/engine.py).

A saved program (`jit.save(..., input_spec=...)`) runs one shape per
(batch bucket, sequence bucket); the engine forces concurrent traffic
through that small set of shapes while keeping tail latency bounded.

Pipeline:

  submit() -> [shape check / decode reject, circuit breaker]
           -> request queue
           -> dynamic batcher (coalesce up to max_batch_size rows or
              batch_timeout_ms, grouped by shape key; batch dim padded
              to pow2 buckets via io/bucketing)
           -> round-robin over the ACTIVE replicas, each a worker thread
              on the Predictor's device
           -> per-request futures (order-matched slices of the batch)

Robustness: per-request deadlines (503 on queue expiry), error isolation
(a bad request is rejected before it can poison a batch; a batch-level
runtime failure splits in half and retries once, failing only the
culprit half), a circuit breaker (queue depth bound -> 503 + Retry-After
from the observed drain rate, the bound stretched by
overload_queue_factor while an attached autoscaler reports headroom),
and a shutdown that drains in-flight work.

Elasticity: ``add_replica()`` runs every bucket on the new replica's
device before admitting it to the round-robin; ``remove_replica(drain=
True)`` retires one after its queued batches complete;
``revive_replica()`` supersedes a hung worker thread and requeues its
batch (futures complete exactly once, so a late zombie cannot clobber a
retried result).

Warm-up runs every (replica, bucket) once before the replica is
admitted, so that a served batch never is a shape's first call
(`ServingMetrics`' "compiles" counter counts such first calls). Eager
PyTorch compiles nothing and the port has no persistent compile cache:
`warmup_report` and `add_replica`'s report leave out the reference's
`persistent_hits`, `persistent_misses` and `persistent_cache_enabled`.

Replicas: every replica runs on the Predictor's device (the exported
program is bound to the device it was exported on), and all of them
share its module; a card runs their batches in turn on its current
stream, while the host work of one batch (assembly, copies, slicing)
overlaps another's device work.

Chaos sites (testing/chaos): ``scale.add`` / ``scale.drain`` in the
scale paths, ``serving.execute`` on the worker thread before every
device batch. Spans: ``serving.enqueue`` on the client thread,
``serving.queue_wait`` on the batcher, ``serving.execute`` (holding the
Predictor's ``predictor.h2d``, ``predictor.forward`` and
``predictor.d2h``) and ``serving.reply`` on the worker.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from queue import Empty
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ...core.flags import flag
from ...io.bucketing import (bucket_boundaries_pow2, bucket_for,
                             pad_batch_rows)
from ...observability import trace as _tr
from ...testing import chaos as _chaos
from ...testing.racecheck import shared_state as _shared_state
from .lifecycle import Future, ReplicaSlot, ServingError


class _Request:
    __slots__ = ("inputs", "rows", "shape_key", "shape_key_str", "future",
                 "deadline", "t_enqueue", "t_enq_ns", "ctx", "requeues")

    def __init__(self, inputs, rows, shape_key, shape_key_str, deadline):
        self.inputs = inputs
        self.rows = rows
        self.shape_key = shape_key
        self.shape_key_str = shape_key_str
        self.future = Future()
        self.deadline = deadline
        self.t_enqueue = time.monotonic()
        # the request's enqueue-span context (None with tracing off);
        # t_enq_ns anchors its queue-wait span on the tracer's clock
        self.t_enq_ns = time.perf_counter_ns()
        self.ctx = None
        self.requeues = 0  # charged re-dispatches (bounded)


_Replica = ReplicaSlot


@_shared_state("_queue", "_replicas", "_warmed", "_rr", "_next_rid",
               "_closing", "_shut", "_batcher_done")
class ServingEngine:
    """Concurrent serving front of a saved ``.pdmodel``.

    `model` is a path prefix (as save_inference_model / jit.save with
    input_spec write it) or an inference.Predictor; `device` is where a
    prefix's Predictor runs (None: the card; a Predictor keeps its own).
    Requests are lists of arrays, one per model input, each with a
    leading batch dimension (>= 1 rows), so one client may send a
    multi-row request and still be coalesced with others.

    Output contract: an output whose leading dim equals the executed
    batch is per-row and sliced back to each request; any other output is
    batch-invariant and shared by every request of the batch.
    """

    def __init__(self, model, max_batch_size: Optional[int] = None,
                 batch_timeout_ms: Optional[float] = None,
                 replicas: Optional[int] = None,
                 max_queue_depth: Optional[int] = None,
                 default_deadline_ms: Optional[float] = None,
                 seq_boundaries: Optional[Sequence[int]] = None,
                 seq_pad_value=0, warmup: bool = True,
                 auto_start: bool = True, retry_after_s: float = 0.5,
                 retry_after_max_s: float = 30.0,
                 overload_queue_factor: float = 2.0, device=None):
        from .. import Predictor, config_for
        from .metrics import ServingMetrics, track_engine

        if isinstance(model, str):
            model = Predictor(config_for(model, device))
        self._predictor = model
        self._meta = model._meta
        self._specs = self._meta["input_specs"]
        self._n_outputs = len(self._meta["output_names"])
        for i, s in enumerate(self._specs):
            if not s["shape"]:
                raise ValueError(
                    f"input {i} is rank-0 (no batch dim) — the engine "
                    f"batches along dim 0; export with a leading "
                    f"symbolic batch axis")
            if s["shape"][0] is not None:
                raise ValueError(
                    f"input {i} has a STATIC batch dim {s['shape'][0]}; "
                    f"dynamic batching needs a symbolic one — export with "
                    f"input_spec=[InputSpec((None, ...), ...)]")

        self._max_rows = int(max_batch_size
                             if max_batch_size is not None
                             else flag("serving_max_batch_size"))
        self._batch_timeout = float(
            batch_timeout_ms if batch_timeout_ms is not None
            else flag("serving_batch_timeout_ms")) / 1e3
        self._max_queue_depth = int(
            max_queue_depth if max_queue_depth is not None
            else flag("serving_max_queue_depth"))
        dl = float(default_deadline_ms if default_deadline_ms is not None
                   else flag("serving_default_deadline_ms"))
        self._default_deadline_s = dl / 1e3 if dl > 0 else None
        self._retry_after_s = float(retry_after_s)
        self._retry_after_max_s = float(retry_after_max_s)
        self._overload_queue_factor = max(1.0, float(overload_queue_factor))
        self._boundaries = bucket_boundaries_pow2(1, self._max_rows)
        self._seq_boundaries = sorted(seq_boundaries) if seq_boundaries \
            else None
        self._seq_pad_value = seq_pad_value

        self._device = model.device
        n_rep = int(replicas) if replicas else 1

        self._cv = threading.Condition()
        self._queue: "deque[_Request]" = deque()
        self._closing = False
        self._shut = False
        self._batcher_done = False
        self._rr = 0
        self._next_rid = 0
        self._warmed: set = set()        # (bucket, shapes)
        self._replicas: List[_Replica] = []
        for _ in range(max(n_rep, 1)):
            self._replicas.append(self._new_replica())
        self._batcher: Optional[threading.Thread] = None
        # the autoscaler's hook: its remaining scale-up headroom. While
        # positive, the breaker stretches the queue bound by
        # overload_queue_factor (scale -> queue -> shed, in that order)
        self.scale_headroom_fn = None

        self.metrics = ServingMetrics()
        # a GIL-atomic len of a deque whose writers hold _cv: the scrape
        # thread never contends for the engine
        self.metrics.queue_depth_fn = lambda: len(self._queue)
        self.metrics.replicas_fn = lambda: len(self._active())
        track_engine(self)

        self.warmup_report = None
        if warmup:
            self.warm_up()
        else:
            for rep in self._replicas:
                rep.state = "active"
        if auto_start:
            self.start()

    # ---------------------------------------------------------- replicas --
    def _new_replica(self) -> _Replica:
        """A replica in state 'warming' (not yet admitted). Only __init__
        and add_replica call this."""
        rep = _Replica(self._next_rid, self._device)
        self._next_rid += 1
        return rep

    def _active(self) -> List[_Replica]:
        # under _cv (an RLock, so locked callers nest): the autoscaler's
        # probe and the breaker read this while add/remove change the pool
        with self._cv:
            return [r for r in self._replicas if r.state == "active"]

    def replica_states(self) -> List[dict]:
        """One row per replica with monotonic ages, built under the
        engine lock (every writer of the lifecycle fields holds it)."""
        now = time.monotonic()
        with self._cv:
            return [r.state_row(now) for r in self._replicas]

    def add_replica(self, device=None, warm: bool = True) -> dict:
        """Grow the pool at run time: run every bucket on the new
        replica's device first (on the caller's thread, while the pool
        serves), then admit it to the round-robin. `device` must be the
        Predictor's."""
        _chaos.hit("scale.add")
        if device is not None and str(device) != str(self._device):
            raise ValueError(
                f"device {device} is not the Predictor's "
                f"({self._device}): a program runs on the device it was "
                f"loaded on")
        with self._cv:
            if self._closing:
                raise ServingError(503, "server shutting down",
                                   retry_after=self._retry_after_s)
            rep = self._new_replica()
            self._replicas.append(rep)
        t0 = time.perf_counter()
        try:
            warmed = self._warm_replica(rep) if warm else 0
            started = self._batcher is not None
            if started:
                self._start_worker(rep)
        except Exception:
            # a failed warm-up or spawn must not leave a replica
            # 'warming' forever
            with self._cv:
                if rep in self._replicas:
                    self._replicas.remove(rep)
            raise
        with self._cv:
            rep.state = "active"
            self._cv.notify_all()
        return {
            "rid": rep.rid,
            "device": str(rep.device),
            "warmed_executables": warmed,
            "warm_time_s": round(time.perf_counter() - t0, 3),
            "admitted_after_warmup": True,
            "worker_started": started,
        }

    def remove_replica(self, rid: Optional[int] = None, drain: bool = True,
                       timeout: float = 30.0) -> dict:
        """Retire one replica. drain=True (scale-down): the batcher stops
        dispatching to it, its queued batches complete, then the worker
        exits. drain=False (a dead device): the worker is superseded and
        its queued and in-flight requests requeued on the others."""
        _chaos.hit("scale.drain", rid=rid if rid is not None else -1)
        with self._cv:
            target = None
            if rid is None:
                # an unnamed removal picks an ACTIVE replica: removing one
                # already draining would be a silent no-op
                actives = [r for r in self._replicas
                           if r.state == "active"]
                target = actives[-1] if actives else None
            else:
                for r in self._replicas:
                    if r.rid == rid and r.state in ("active", "draining"):
                        target = r
            if target is None:
                raise ValueError(f"no removable replica (rid={rid})")
            n_active = sum(1 for r in self._replicas
                           if r.state == "active")
            if n_active <= 1 and target.state == "active":
                raise ValueError(
                    "cannot remove the last active replica — the queue "
                    "would starve; add a replacement first")
            target.state = "draining"
            self._cv.notify_all()
        if drain:
            with self._cv:
                self._cv.wait_for(
                    lambda: target.state == "retired", timeout)
                drained = target.state == "retired"
        else:
            self._supersede(target, retire=True)
            drained = False
        with self._cv:
            return {"rid": target.rid, "drained": drained,
                    "state": target.state}

    def revive_replica(self, rid: int) -> dict:
        """Replace a (presumed hung) replica's worker thread: bump the
        generation so the stuck thread is a zombie once it unwedges,
        requeue its in-flight batch and start a fresh worker on the same
        queue."""
        with self._cv:
            target = None
            for r in self._replicas:
                if r.rid == rid and r.state in ("active", "draining"):
                    target = r
            if target is None:
                raise ValueError(f"no live replica rid={rid}")
        self._supersede(target, retire=False)
        with self._cv:
            return {"rid": rid, "generation": target.generation}

    def _supersede(self, rep: _Replica, retire: bool) -> None:
        """Abandon rep's worker (generation bump); respawn one
        (retire=False) or retire the replica and requeue what it holds."""
        with self._cv:
            rep.generation += 1
            gen = rep.generation
            stuck = list(rep.inflight)
            rep.inflight = []
            rep.busy_since = None
            if retire:
                rep.state = "retired"
        self._requeue(stuck)
        if retire:
            # batches the batcher already queued on it; a put racing
            # this sweep is reclaimed by the batcher's own re-check
            self._scavenge_queue(rep)
            with self._cv:
                self._cv.notify_all()
        else:
            with self._cv:
                rep.last_beat = time.monotonic()
            self._start_worker(rep, gen)

    def _scavenge_queue(self, rep: _Replica) -> None:
        while True:
            try:
                batch = rep.q.get_nowait()
            except Empty:
                return
            if batch:
                self._requeue(batch, charge=False)

    def _requeue(self, reqs: List[_Request], charge: bool = True) -> None:
        """Put unfinished requests back at the FRONT of the queue. A
        request survives one charged requeue (caught mid-execute on a hung
        worker); a second fails it 503. charge=False is for batches that
        never started executing (a drain or retire race)."""
        if not reqs:
            return
        with self._cv:
            # once the batcher has exited nothing consumes the queue:
            # complete the requests with a 503 instead
            dead = self._batcher_done
            for req in reversed(reqs):
                if req.future.done():
                    continue
                if (charge and req.requeues >= 1) or dead:
                    msg = ("server shutting down while request was in "
                           "flight" if dead else
                           "replica replaced twice while request was "
                           "in flight")
                    if req.future.set_error(ServingError(
                            503, msg,
                            retry_after=self._retry_after())):
                        self.metrics.on_failed(1)
                    continue
                if charge:
                    req.requeues += 1
                self._queue.appendleft(req)
            self._cv.notify_all()

    # ------------------------------------------------------------ warmup --
    def _static_sample_shape(self, spec) -> Optional[Tuple[int, ...]]:
        """Per-sample (non-batch) shape with dynamic dims at the smallest
        seq bucket; None when unwarmable (a dynamic dim, no
        seq_boundaries)."""
        out = []
        for d in spec["shape"][1:]:
            if d is None:
                if not self._seq_boundaries:
                    return None
                out.append(self._seq_boundaries[0])
            else:
                out.append(int(d))
        return tuple(out)

    def _seq_variants(self) -> List[Optional[int]]:
        if self._seq_boundaries and any(
                d is None for s in self._specs for d in s["shape"][1:]):
            return list(self._seq_boundaries)
        return [None]

    def _warm_replica(self, rep: _Replica) -> int:
        """Run every (batch bucket[, seq bucket]) shape once on rep's
        device; returns the number of shapes run."""
        sample_shapes = [self._static_sample_shape(s) for s in self._specs]
        if any(s is None for s in sample_shapes):
            return 0
        n = 0
        for b in self._boundaries:
            for seq in self._seq_variants():
                arrays, key_parts = [], []
                for spec in self._specs:
                    dims = [b]
                    for d in spec["shape"][1:]:
                        dims.append(int(seq) if d is None else int(d))
                    arrays.append(np.zeros(dims, np.dtype(spec["dtype"])))
                    key_parts.append(tuple(dims[1:]))
                self._run_on_device(arrays)
                with self._cv:
                    self._warmed.add((b, tuple(key_parts)))
                n += 1
        return n

    def _admit_warming(self):
        """Admit only WARMING replicas: a later warm_up() must not revive
        retired or draining ones whose workers are gone."""
        with self._cv:
            for rep in self._replicas:
                if rep.state == "warming":
                    rep.state = "active"
            self._cv.notify_all()

    def warm_up(self):
        """Run every (replica, batch bucket[, seq bucket]) shape once, so
        that no served batch is a shape's first call; records
        warmup_report, then admits the replicas."""
        t0 = time.perf_counter()
        if any(self._static_sample_shape(s) is None for s in self._specs):
            self.warmup_report = {
                "skipped": "dynamic non-batch dims without seq_boundaries"}
            self._admit_warming()
            return
        n = 0
        with self._cv:
            warming = [r for r in self._replicas if r.state == "warming"]
        for rep in warming:
            n += self._warm_replica(rep)
        self._admit_warming()
        with self._cv:
            warmed_count = len(self._warmed)
        self.warmup_report = {
            "time_s": round(time.perf_counter() - t0, 3),
            # unique shapes per device (replicas on one device share
            # them), as health()["warmed_executables"]; warm_passes
            # counts the per-replica runs
            "executables": warmed_count,
            "warm_passes": n,
            "replicas": len(self._replicas),
            "batch_buckets": list(self._boundaries),
        }

    # --------------------------------------------------------- lifecycle --
    def start(self):
        """Start the batcher and one worker thread per replica."""
        if self._batcher is not None:
            return
        self._batcher = threading.Thread(
            target=self._batcher_loop, name="serving-batcher", daemon=True)
        self._batcher.start()
        with self._cv:
            cold = [rep for rep in self._replicas if rep.thread is None]
        for rep in cold:
            self._start_worker(rep)

    def _start_worker(self, rep: _Replica,
                      gen: Optional[int] = None) -> None:
        with self._cv:
            if gen is None:
                gen = rep.generation
            t = threading.Thread(target=self._worker_loop,
                                 args=(rep, gen),
                                 name=f"serving-replica-{rep.rid}",
                                 daemon=True)
            # under the lock: a superseded zombie reads rep.thread while
            # the revive path installs the replacement
            rep.thread = t
        t.start()

    def shutdown(self, drain: bool = True, timeout: float = 60.0):
        """Stop accepting requests; with drain=True every queued and
        in-flight request completes before the threads exit, otherwise
        the queue fails fast with 503."""
        with self._cv:
            if self._shut:
                return
            self._shut = True
            self._closing = True
            if not drain:
                while self._queue:
                    r = self._queue.popleft()
                    r.future.set_error(
                        ServingError(503, "server shutting down",
                                     retry_after=self._retry_after_s))
            self._cv.notify_all()
        if self._batcher is None:
            # never started: nothing drains the queue, so start the
            # threads and let them flush it
            self.start()
        self._batcher.join(timeout)
        with self._cv:
            threads = [r.thread for r in self._replicas if r.thread]
        for t in threads:
            t.join(timeout)

    def health(self) -> dict:
        with self._cv:
            states = [r.state for r in self._replicas]
            return {
                "status": "draining" if self._closing else "ok",
                "replicas": states.count("active"),
                "replica_states": {s: states.count(s)
                                   for s in set(states)},
                "queue_depth": len(self._queue),
                "batch_buckets": list(self._boundaries),
                "warmed_executables": len(self._warmed),
            }

    def load_report(self) -> dict:
        """Few-field load digest (a fabric heartbeat's)."""
        with self._cv:
            depth = len(self._queue)
            replicas = sum(1 for r in self._replicas
                           if r.state == "active")
            draining = self._closing
        return {
            "queue_depth": depth,
            "replicas": replicas,
            "qps": round(self.metrics.qps(), 3),
            "status": "draining" if draining else "ok",
        }

    # ------------------------------------------------------------ submit --
    def _retry_after(self) -> float:
        """The time to clear the backlog at the observed completion rate,
        clamped to [retry_after_s, retry_after_max_s]."""
        depth = len(self._queue)
        qps = self.metrics.qps()
        if depth <= 0 or qps <= 0.0:
            return self._retry_after_s
        est = depth / qps
        return min(max(est, self._retry_after_s), self._retry_after_max_s)

    def _queue_bound(self) -> int:
        """The breaker's bound, stretched by overload_queue_factor while
        the attached autoscaler reports scale-up headroom."""
        fn = self.scale_headroom_fn
        if fn is not None:
            try:
                if int(fn()) > 0:
                    return int(self._max_queue_depth *
                               self._overload_queue_factor)
            except Exception:  # noqa: BLE001 — a sick headroom probe
                pass           # must not break the breaker itself
        return self._max_queue_depth

    def _decode_request(self, inputs, deadline_ms) -> _Request:
        if len(inputs) != len(self._specs):
            self.metrics.on_reject("input_count")
            raise ServingError(
                400, f"expected {len(self._specs)} inputs, "
                     f"got {len(inputs)}")
        rows = None
        arrays, key_parts = [], []
        for i, (arr, spec) in enumerate(zip(inputs, self._specs)):
            try:
                a = np.asarray(arr)
                want = np.dtype(spec["dtype"])
                if a.dtype != want:
                    a = a.astype(want, casting="same_kind")
            except (TypeError, ValueError) as e:
                self.metrics.on_reject("decode")
                raise ServingError(400, f"input {i}: {e}") from None
            shape = spec["shape"]
            if a.ndim != len(shape) or a.shape[0] < 1:
                self.metrics.on_reject("shape")
                raise ServingError(
                    400, f"input {i}: rank/rows mismatch — got shape "
                         f"{tuple(a.shape)} for spec {shape}")
            if rows is None:
                rows = int(a.shape[0])
            elif int(a.shape[0]) != rows:
                self.metrics.on_reject("shape")
                raise ServingError(
                    400, f"input {i}: inconsistent row count "
                         f"{a.shape[0]} vs {rows}")
            for d, (have, want_d) in enumerate(zip(a.shape[1:], shape[1:]),
                                               start=1):
                if want_d is None:
                    continue
                if int(have) != int(want_d):
                    self.metrics.on_reject("shape")
                    raise ServingError(
                        400, f"input {i} dim {d}: got {have}, "
                             f"spec requires {want_d}")
            if self._seq_boundaries:
                # pad dynamic non-batch axes up to their seq bucket so that
                # near-length requests share one shape (the model must be
                # padding-invariant)
                for d, want_d in enumerate(shape[1:], start=1):
                    if want_d is not None:
                        continue
                    try:
                        target = bucket_for(a.shape[d],
                                            self._seq_boundaries)
                    except ValueError as e:
                        self.metrics.on_reject("shape")
                        raise ServingError(400, f"input {i}: {e}") \
                            from None
                    if target != a.shape[d]:
                        pad = [(0, 0)] * a.ndim
                        pad[d] = (0, target - a.shape[d])
                        a = np.pad(a, pad,
                                   constant_values=self._seq_pad_value)
            arrays.append(np.ascontiguousarray(a))
            key_parts.append(tuple(int(d) for d in a.shape[1:]))
        try:
            bucket_for(rows, self._boundaries)
        except ValueError:
            self.metrics.on_reject("too_large")
            raise ServingError(
                400, f"request has {rows} rows; max_batch_size is "
                     f"{self._max_rows}") from None
        dl_s = None
        if deadline_ms is not None and float(deadline_ms) > 0:
            dl_s = float(deadline_ms) / 1e3
        elif self._default_deadline_s is not None:
            dl_s = self._default_deadline_s
        deadline = time.monotonic() + dl_s if dl_s is not None else None
        key_str = ",".join("x".join(map(str, kp)) or "-"
                           for kp in key_parts)
        return _Request(arrays, rows, tuple(key_parts), key_str, deadline)

    def submit(self, inputs, deadline_ms: Optional[float] = None) -> Future:
        """Enqueue one request; returns its Future. Raises ServingError at
        once for decode and shape rejects (400) and load shedding (503)."""
        # shed before paying for the decode (a racy read; the check under
        # the lock below decides)
        bound = self._queue_bound()
        if self._closing or len(self._queue) >= bound:
            with self._cv:
                if self._closing:
                    raise ServingError(503, "server shutting down",
                                       retry_after=self._retry_after_s)
                if len(self._queue) >= bound:
                    self.metrics.on_shed()
                    raise ServingError(
                        503, f"queue depth {len(self._queue)} at bound "
                             f"{bound} — load shed",
                        retry_after=self._retry_after())
        # the root of the request's trace: decode and enqueue on the
        # client's thread (a shared no-op with tracing off)
        with _tr.span("serving.enqueue", "serving") as sp:
            req = self._decode_request(inputs, deadline_ms)
            req.ctx = sp.ctx
            sp.set(rows=req.rows)
            with self._cv:
                if self._closing:
                    raise ServingError(503, "server shutting down",
                                       retry_after=self._retry_after_s)
                if len(self._queue) >= bound:
                    self.metrics.on_shed()
                    raise ServingError(
                        503, f"queue depth {len(self._queue)} at bound "
                             f"{bound} — load shed",
                        retry_after=self._retry_after())
                self._queue.append(req)
                self.metrics.on_accept()
                self._cv.notify_all()
        return req.future

    def predict(self, inputs, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = 120.0):
        """Synchronous submit + wait."""
        return self.submit(inputs, deadline_ms).result(timeout)

    # ----------------------------------------------------------- batcher --
    def _pop_expired_locked(self, req: _Request, now: float) -> bool:
        if req.deadline is not None and now > req.deadline:
            self.metrics.on_deadline_expired()
            req.future.set_error(
                ServingError(503, "deadline exceeded while queued",
                             retry_after=self._retry_after_s))
            return True
        return False

    def _take_first_locked(self) -> Optional[_Request]:
        now = time.monotonic()
        while self._queue:
            req = self._queue.popleft()
            if not self._pop_expired_locked(req, now):
                return req
        return None

    def _take_matching_locked(self, shape_key, rows_left) -> \
            Optional[_Request]:
        now = time.monotonic()
        i = 0
        while i < len(self._queue):
            req = self._queue[i]
            if self._pop_expired_locked(req, now):
                del self._queue[i]
                continue
            if req.shape_key == shape_key and req.rows <= rows_left:
                del self._queue[i]
                return req
            i += 1
        return None

    def _pick_replica_locked(self) -> Optional[_Replica]:
        active = self._active()
        if not active:
            return None
        rep = active[self._rr % len(active)]
        self._rr += 1
        return rep

    def _batcher_loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._closing:
                    self._cv.wait(0.05)
                if not self._queue and self._closing:
                    break
                first = self._take_first_locked()
            if first is None:
                continue
            batch = [first]
            rows = first.rows
            flush_at = time.monotonic() + self._batch_timeout
            while rows < self._max_rows:
                with self._cv:
                    got = self._take_matching_locked(
                        first.shape_key, self._max_rows - rows)
                    if got is None:
                        if self._closing:
                            break
                        remaining = flush_at - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(min(remaining, 0.005))
                        continue
                batch.append(got)
                rows += got.rows
            self._dispatch_batch(batch)
        with self._cv:
            self._batcher_done = True
            # a requeue racing our exit decision may have appended after
            # the break: fail those so that no future is stranded
            stranded = list(self._queue)
            self._queue.clear()
            reps = list(self._replicas)
        for r in stranded:
            if r.future.set_error(ServingError(
                    503, "server shutting down while request was in "
                         "flight", retry_after=self._retry_after_s)):
                self.metrics.on_failed(1)
        for rep in reps:
            # a poison pill; a wedged replica's full queue must not block
            # the batcher (every worker also exits on Empty once
            # _batcher_done is set)
            try:
                rep.q.put_nowait(None)
            except Exception:  # noqa: BLE001 — queue.Full
                pass

    def _dispatch_batch(self, batch: List[_Request]) -> None:
        """Place one batch on an active replica's queue (a blocking put:
        backpressure); if the replica retired meanwhile, reclaim it."""
        while True:
            with self._cv:
                rep = self._pick_replica_locked()
                if rep is None:
                    if self._closing:
                        n_failed = 0
                        for r in batch:
                            if r.future.set_error(ServingError(
                                    503,
                                    "no replicas left — shutting down",
                                    retry_after=self._retry_after_s)):
                                n_failed += 1
                        if n_failed:
                            self.metrics.on_failed(n_failed)
                        return
            if rep is None:
                time.sleep(0.01)
                continue
            try:
                rep.q.put(batch, timeout=0.5)
            except Exception:  # noqa: BLE001 — queue.Full: replica is
                continue       # slow/wedged; round-robin to the next
            if _tr.enabled():
                # one queue-wait span per request on the batcher thread,
                # after the put landed (a retried put emits none)
                now_ns = time.perf_counter_ns()
                for r in batch:
                    _tr.emit_span("serving.queue_wait", r.t_enq_ns,
                                  now_ns, parent=r.ctx, cat="serving",
                                  args={"coalesced": len(batch),
                                        "replica": rep.rid})
            with self._cv:
                abandoned = rep.state == "retired"
            if abandoned:
                self._scavenge_queue(rep)
            return

    # ----------------------------------------------------------- workers --
    def _worker_loop(self, rep: _Replica, gen: int):
        q = rep.q
        while True:
            with self._cv:
                if rep.generation != gen:
                    return  # superseded by revive_replica
                rep.last_beat = time.monotonic()
            try:
                batch = q.get(timeout=0.1)
            except Empty:
                with self._cv:
                    idle_exit = rep.state in ("draining", "retired") \
                        or self._batcher_done
                if idle_exit:
                    retired = False
                    with self._cv:
                        if rep.generation == gen and rep.q.empty():
                            rep.state = "retired"
                            self._cv.notify_all()
                            retired = True
                    if retired:
                        # a batch landed between the empty() check and
                        # the state flip: sweep it back
                        self._scavenge_queue(rep)
                        return
                continue
            if batch is None:
                with self._cv:
                    if rep.generation == gen:
                        rep.state = "retired"
                        self._cv.notify_all()
                return
            with self._cv:
                superseded = rep.generation != gen
            if superseded:
                self._requeue([r for r in batch if not r.future.done()],
                              charge=False)
                return
            now = time.monotonic()
            live = []
            for r in batch:
                if r.deadline is not None and now > r.deadline:
                    self.metrics.on_deadline_expired()
                    r.future.set_error(ServingError(
                        503, "deadline exceeded while queued",
                        retry_after=self._retry_after_s))
                else:
                    live.append(r)
            if live:
                with self._cv:
                    owned = rep.generation == gen
                    if owned:
                        rep.inflight = live
                        rep.busy_since = time.monotonic()
                if not owned:
                    self._requeue([r for r in live
                                   if not r.future.done()],
                                  charge=False)
                    return
                try:
                    self._run_group(rep, gen, live,
                                    allow_split=True)
                except Exception as e:  # noqa: BLE001 — a worker thread
                    # must never die (its queue would wedge the replica):
                    # fail the batch and keep serving
                    n_failed = 0
                    for r in live:
                        if not r.future.done():
                            n_failed += 1
                            r.future.set_error(ServingError(
                                500, f"internal: {e!r}"[:2000]))
                    if n_failed:
                        self.metrics.on_failed(n_failed)
                finally:
                    # only the owning generation clears the markers
                    with self._cv:
                        if rep.generation == gen:
                            rep.busy_since = None
                            rep.inflight = []
                            rep.compiling = False
                        rep.batches += 1

    def _run_on_device(self, arrays):
        """Run the program on one batch of host arrays (on the
        Predictor's device, which every replica's is)."""
        return self._predictor.execute(arrays)

    def _run_group(self, rep: _Replica, gen: int,
                   group: List[_Request], allow_split: bool):
        rows = sum(r.rows for r in group)
        bucket = bucket_for(rows, self._boundaries)
        key = (bucket, group[0].shape_key)
        # a shape the warm-up did not run is this batch's first call;
        # only the owning thread sets the flag its finally clears
        with self._cv:
            compiled = key not in self._warmed
            if rep.thread is threading.current_thread():
                rep.compiling = compiled
        exec_args = None
        if _tr.enabled():
            exec_args = {"replica": rep.rid, "bucket": bucket,
                         "rows": rows, "requests": len(group),
                         "traces": [r.ctx.trace_id for r in group
                                    if r.ctx is not None]}
        try:
            # the hang-injection point: a chaos `delay` here wedges this
            # worker mid-execute like a stuck device; the generation in
            # the context scopes a rule to one worker incarnation
            _chaos.hit("serving.execute", replica=rep.rid,
                       generation=gen)
            # batch assembly is inside the failure domain too
            with _tr.span("serving.execute", "serving", exec_args,
                          parent=group[0].ctx):
                arrays = []
                for i in range(len(self._specs)):
                    stacked = group[0].inputs[i] if len(group) == 1 else \
                        np.concatenate([r.inputs[i] for r in group],
                                       axis=0)
                    arrays.append(pad_batch_rows(stacked,
                                                 self._boundaries))
                outs = self._run_on_device(arrays)
        except Exception as e:  # noqa: BLE001 — isolate, then surface
            if allow_split and len(group) > 1:
                # split once and retry the halves: only the culprit
                # half's requests fail
                self.metrics.on_split()
                mid = len(group) // 2
                self._run_group(rep, gen, group[:mid],
                                allow_split=False)
                self._run_group(rep, gen, group[mid:],
                                allow_split=False)
            else:
                n_failed = 0
                for r in group:
                    if r.future.set_error(ServingError(
                            500, f"batch execution failed: {e!r}"[:2000])):
                        n_failed += 1
                if n_failed:
                    self.metrics.on_failed(n_failed)
            return
        with self._cv:
            self._warmed.add(key)
        self.metrics.on_batch(len(group), rows, bucket,
                              group[0].shape_key_str, compiled)
        done = time.monotonic()
        off = 0
        for r in group:
            t0_ns = time.perf_counter_ns() if _tr.enabled() else 0
            sliced = []
            for o in outs:
                if getattr(o, "ndim", 0) >= 1 and o.shape[0] == \
                        arrays[0].shape[0]:
                    sliced.append(o[off:off + r.rows])
                else:
                    sliced.append(o)  # batch-invariant output: share it
            off += r.rows
            if r.future.set_result(sliced):
                self.metrics.on_complete(done - r.t_enqueue)
            if t0_ns:
                _tr.emit_span("serving.reply", t0_ns,
                              time.perf_counter_ns(), parent=r.ctx,
                              cat="serving", args={"rows": r.rows})


__all__ = ["ServingEngine", "ServingError", "Future"]
