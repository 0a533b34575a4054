"""hapi callbacks (counterpart of paddle_tpu/hapi/callbacks.py): the
fit loop's hooks, the progress logger, checkpoints, early stopping, the
LR callbacks, the profiler's callback and the metrics bus's. VisualDL
and Weights & Biases logging are not ported (their packages are not
among the port's dependencies)."""
from __future__ import annotations

import time


class Callback:
    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = list(callbacks)

    def set_model(self, model):
        for c in self.callbacks:
            c.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def call(*args, **kwargs):
                for c in self.callbacks:
                    getattr(c, name)(*args, **kwargs)

            return call
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._start = time.perf_counter()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            print(f"epoch {self._epoch} step {step}: "
                  f"loss {logs.get('loss', 0):.4f}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"epoch {epoch} done in "
                  f"{time.perf_counter() - self._start:.1f}s "
                  f"loss {logs.get('loss', 0):.4f}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(f"{self.save_dir}/{epoch}")


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="min", patience=0, min_delta=0,
                 baseline=None, save_best_model=True):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.best = None
        self.wait = 0

    def on_epoch_end(self, epoch, logs=None):
        v = (logs or {}).get(self.monitor)
        if v is None:
            return
        better = (self.best is None or
                  (self.mode == "min" and v < self.best - self.min_delta) or
                  (self.mode == "max" and v > self.best + self.min_delta))
        if better:
            self.best = v
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            sched = getattr(self.model._optimizer, "_lr_scheduler", None)
            if sched is not None:
                sched.step()


class ReduceLROnPlateau(Callback):
    """Reduce optimizer LR when a monitored metric plateaus (reference
    hapi/callbacks.py ReduceLROnPlateau)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.mode = "min" if mode in ("auto", "min") else "max"
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def on_eval_end(self, logs=None):
        self._check(logs)

    def on_epoch_end(self, epoch, logs=None):
        self._check(logs)

    def _check(self, logs):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        better = (self.best is None
                  or (self.mode == "min" and cur < self.best - self.min_delta)
                  or (self.mode == "max" and cur > self.best + self.min_delta))
        if better:
            self.best = cur
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None and not callable(
                    getattr(opt, "_learning_rate", None)):
                try:
                    new_lr = max(opt.get_lr() * self.factor, self.min_lr)
                    opt.set_lr(new_lr)
                except RuntimeError:
                    pass  # scheduler-driven LR: scheduler owns it
            self.cooldown_counter = self.cooldown
            self.wait = 0


class ProfilerCallback(Callback):
    """Drive a profiler.Profiler through a fit loop: start at train
    begin, a profiler step a batch, stop and print the summary (op,
    module, step, memory and kernel tables) at train end.

    Pass a Profiler, or keyword arguments for a new one (defaults:
    timer_only=True, so no device trace; profile_memory=True;
    with_flops=True). `print_summary=False` keeps the summary's text in
    `last_summary` unprinted.
    """

    def __init__(self, profiler=None, print_summary=True, **profiler_kwargs):
        from .. import profiler as prof_mod

        if profiler is None:
            profiler_kwargs.setdefault("timer_only", True)
            profiler_kwargs.setdefault("profile_memory", True)
            profiler_kwargs.setdefault("with_flops", True)
            profiler = prof_mod.Profiler(**profiler_kwargs)
        self.profiler = profiler
        self.print_summary = print_summary
        self.last_summary = None

    def on_train_begin(self, logs=None):
        self.profiler.start()

    def on_train_batch_end(self, step, logs=None):
        self.profiler.step()

    def on_train_end(self, logs=None):
        self.profiler.stop()
        if self.print_summary:
            self.last_summary = self.profiler.summary()
        else:
            from ..profiler import stats as _stats

            self.last_summary = _stats.build_summary(self.profiler)


class TelemetryCallback(Callback):
    """Feed the metrics bus (observability.bus) from a fit loop: one row
    a train step with the loss, the step time, MFU and the input
    pipeline's queue depth and starvation fraction. With
    ``FLAGS_metrics_dir`` set the series goes to ``<dir>/metrics.jsonl``
    and a Prometheus textfile ``<dir>/metrics.prom`` is rewritten every
    `flush_every` steps. ``Model.fit`` adds this callback when
    FLAGS_metrics_dir is set. The reference's row also carries the
    fault-tolerance checkpoint's stall and bad steps; the port has no
    fault-tolerance supervisor (ROADMAP queue 5), so those fields are
    absent.

    MFU comes from a ``timer_only`` Profiler of its own; when a profiler
    already runs (a ProfilerCallback's), the callback reads that one's
    step records instead, without stepping or stopping it (the host
    event buffer is process-wide), and reports MFU only for batches
    that added a record."""

    def __init__(self, flush_every: int = 50):
        from .. import profiler as prof_mod

        self._prof_mod = prof_mod
        self.flush_every = max(1, int(flush_every))
        self._prof = None
        self._owns_prof = False
        self._started = False
        self._seen_records = 0
        self._t_last = None
        self._rows = 0

    def on_train_begin(self, logs=None):
        self._started = False
        self._t_last = time.perf_counter()

    def on_train_batch_begin(self, step, logs=None):
        if self._started:
            return
        # decided at the first batch, when every callback's
        # on_train_begin has run, so a ProfilerCallback is found in any
        # order of the list
        self._started = True
        if self._prof_mod.running() is not None:
            self._prof = self._prof_mod.running()
            self._owns_prof = False
        else:
            self._prof = self._prof_mod.Profiler(timer_only=True,
                                                 with_flops=True)
            self._prof.start()
            self._owns_prof = True
        self._seen_records = len(getattr(self._prof, "step_records", []))

    def _sections(self):
        """The input pipeline's scalars (its section is None until a
        pipeline yields)."""
        from ..io.pipeline import metrics as pipe_metrics

        snap = pipe_metrics.summary_snapshot() or {}
        return {"queue_depth": snap.get("host_queue_depth", 0)
                + snap.get("device_queue_depth", 0),
                "starvation_fraction": snap.get("starvation_fraction",
                                                0.0)}

    def on_train_batch_end(self, step, logs=None):
        from ..observability import bus

        now = time.perf_counter()
        dt_ms = (now - self._t_last) * 1e3 if self._t_last is not None \
            else 0.0
        self._t_last = now
        row = {"step": step, "step_time_ms": round(dt_ms, 3),
               "mfu": 0.0, "flops": 0}
        logs = logs or {}
        if "loss" in logs:
            try:
                row["loss"] = float(logs["loss"])
            except (TypeError, ValueError):
                pass
        if "epoch" in logs:
            row["epoch"] = logs["epoch"]
        prof = self._prof
        if prof is not None:
            if self._owns_prof:
                prof.step()
            # the newest step record, only if one came since the last
            # batch (another profiler is stepped by its owner, and a step
            # its scheduler does not record adds none)
            recs = getattr(prof, "step_records", [])
            if len(recs) > self._seen_records:
                rec = recs[-1]
                row["mfu"] = round(rec["mfu"], 6)
                row["flops"] = rec["flops"]
                row["step_time_ms"] = round(rec["time_ms"], 3)
            self._seen_records = len(recs)
        row.update(self._sections())
        bus.record_step(**row)
        self._rows += 1
        if self._rows % self.flush_every == 0:
            bus.flush()

    def on_train_end(self, logs=None):
        from ..observability import bus

        if self._owns_prof and self._prof is not None:
            self._prof.stop()
            self._owns_prof = False
        bus.flush()
