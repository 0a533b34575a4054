"""The high-level Model (counterpart of paddle_tpu/hapi/model.py):
prepare, fit, evaluate, predict, the one-batch calls, save and load.

Built on the port's jit.TrainStep and EvalStep: a step runs on the
network's device (its parameters'), and batches that are not there are
moved to it (a DataLoader's CPU batches by the step, an io.Pipeline's
with `device_prefetch` already on the card). `amp_configs` ("O1"/"O2",
or {"level": ..., "dtype": ...}) runs the forward and the loss under
amp.auto_cast in that dtype, as a bf16 O2 loop does (the parameters'
cast is amp.decorate's, before prepare). `fit` passes `num_workers` and
`drop_last` to the DataLoader it builds from a Dataset.

Not ported (ROADMAP queue 5): `fit(ckpt_dir=...)`, the fault-tolerance
supervisor's checkpointed resume, and `prepare(mesh=..., sharding_rules=...)`;
they raise NotImplementedError.
"""
from __future__ import annotations

import contextlib
import os
from typing import List, Optional

import numpy as np
import torch

from .. import amp as _amp
from .. import framework_io
from ..io import DataLoader, Dataset, Pipeline
from ..jit import EvalStep, TrainStep
from . import callbacks as cbks

_QUEUE5 = "ROADMAP queue 5 (meshes, sharding and fault tolerance)"


def _numpy(t) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _amp_dtype(amp_configs) -> Optional[str]:
    """The auto_cast dtype `amp_configs` asks for, or None."""
    if amp_configs is None:
        return None
    if isinstance(amp_configs, str):
        amp_configs = {"level": amp_configs}
    if amp_configs.get("level", "O1") == "O0":
        return None
    return amp_configs.get("dtype", "bfloat16")


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._train_step = None
        self._eval_step = None
        self._amp = None
        self.stop_training = False

    @property
    def device(self) -> torch.device:
        return next(self.network.parameters()).device

    def _autocast(self):
        if self._amp is None:
            return contextlib.nullcontext()
        return _amp.auto_cast(dtype=self._amp)

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, mesh=None, sharding_rules=None,
                batch_axis="dp"):
        """Set the optimizer, the loss layer and the metrics; with both an
        optimizer and a loss, build the train step."""
        if mesh is not None or sharding_rules is not None:
            raise NotImplementedError(
                f"Model.prepare(mesh=, sharding_rules=) is not ported: "
                f"{_QUEUE5}")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = metrics if isinstance(metrics, (list, tuple)) else \
            ([metrics] if metrics is not None else [])
        self._amp = _amp_dtype(amp_configs)
        if optimizer is not None and loss is not None:
            loss_layer = loss

            def loss_fn(m, x, y):
                with self._autocast():
                    return loss_layer(m(x), y)

            self._train_step = TrainStep(self.network, optimizer, loss_fn)
        return self

    # ------------------------------------------------------------------
    def _as_loader(self, data, batch_size, shuffle, num_workers=0,
                   drop_last=False):
        if data is None:
            return None
        if isinstance(data, (DataLoader, Pipeline)):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)
        raise TypeError("data must be a Dataset, DataLoader or "
                        "io.Pipeline")

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks: Optional[List] = None, accumulate_grad_batches=1,
            num_iters=None, ckpt_dir=None, ckpt_save_steps=10,
            ckpt_keep=3, ckpt_grace_secs=30.0, ckpt_skip_bad_steps=True):
        """Train for `epochs` (or `num_iters` steps); returns
        {"loss": [each step's loss]}. An io.Pipeline runs its epochs by
        iter_epoch (its own seeded order); each step runs under a
        `train.step` span with a `train.data_wait` child when tracing is
        on (observability.trace.step_iter)."""
        assert self._train_step is not None, "call prepare() first"
        if ckpt_dir:
            raise NotImplementedError(
                f"Model.fit(ckpt_dir=...) is not ported: {_QUEUE5}")
        self.stop_training = False
        loader = self._as_loader(train_data, batch_size, shuffle,
                                 num_workers, drop_last)
        callbacks = list(callbacks) if callbacks else \
            [cbks.ProgBarLogger(log_freq, verbose)]
        from ..core.flags import flag as _flag

        if _flag("metrics_dir") and not any(
                isinstance(c, cbks.TelemetryCallback) for c in callbacks):
            # FLAGS_metrics_dir puts the run on the metrics bus
            callbacks.append(cbks.TelemetryCallback())
        cb = cbks.CallbackList(callbacks)
        cb.set_model(self)
        cb.on_train_begin()
        history = {"loss": []}
        try:
            self._fit_loop(cb, loader, history, epochs, eval_data,
                           eval_freq, batch_size, save_dir, save_freq,
                           num_iters)
        finally:
            if isinstance(loader, Pipeline):
                # stop the prefetch threads at once on any exit
                loader.close()
            # the callbacks' cleanup runs even when a batch raised (the
            # profiler's callback removes its dispatch mode and hooks)
            cb.on_train_end()
        return history

    def _fit_loop(self, cb, loader, history, epochs, eval_data, eval_freq,
                  batch_size, save_dir, save_freq, num_iters):
        from ..observability import trace as _tr

        it = 0
        pipeline_mode = isinstance(loader, Pipeline)
        for epoch in range(epochs):
            step_gen = None
            try:
                cb.on_epoch_begin(epoch)
                self.network.train()
                if pipeline_mode:
                    epoch_iter = loader.iter_epoch(epoch)
                    batches = enumerate(epoch_iter, start=epoch_iter.start)
                else:
                    batches = enumerate(loader)
                batches = step_gen = _tr.step_iter(batches)
                for step, batch in batches:
                    cb.on_train_batch_begin(step)
                    x, y = batch[0], batch[1]
                    loss = self._train_step(x, y)
                    logs = {"loss": float(loss), "step": step,
                            "epoch": epoch}
                    history["loss"].append(logs["loss"])
                    cb.on_train_batch_end(step, logs)
                    it += 1
                    if num_iters is not None and it >= num_iters:
                        break
                    if self.stop_training:
                        break
            finally:
                if step_gen is not None:
                    # a break leaves the wrapper inside an iteration with
                    # its train.step span open: close it at the loop's end
                    step_gen.close()
            sched = getattr(self._optimizer, "_lr_scheduler", None)
            if sched is not None:
                sched.step()
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                eval_logs = self.evaluate(eval_data, batch_size=batch_size,
                                          verbose=0)
                cb.on_eval_end(eval_logs)
            cb.on_epoch_end(epoch, {"loss": history["loss"][-1]}
                            if history["loss"] else {})
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/epoch{epoch}")
            if self.stop_training or (num_iters is not None
                                      and it >= num_iters):
                break

    def _eval_forward(self, x):
        if self._eval_step is None:
            self._eval_step = EvalStep(self.network)
        with self._autocast():
            return self._eval_step(x)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """The mean loss over the batches and each metric's
        accumulate(), keyed by the metric's name."""
        loader = self._as_loader(eval_data, batch_size, False, num_workers)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            x, y = batch[0], batch[1]
            out = self._eval_forward(x)
            y = torch.as_tensor(y, device=out.device)
            if self._loss is not None:
                with torch.no_grad(), self._autocast():
                    losses.append(float(self._loss(out, y)))
            for m in self._metrics:
                r = m.compute(out, y)
                m.update(r) if not isinstance(r, tuple) else m.update(*r)
        logs = {}
        if losses:
            logs["loss"] = float(np.mean(losses))
        for m in self._metrics:
            logs[m.name() if isinstance(m.name(), str) else m.name()[0]] = \
                m.accumulate()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None, verbose=1):
        """The network's outputs in eval mode, a numpy array a batch (one
        array with `stack_outputs`)."""
        loader = self._as_loader(test_data, batch_size, False, num_workers)
        self.network.eval()
        outs = []
        for batch in loader:
            x = batch[0] if isinstance(batch, (list, tuple)) else batch
            outs.append(_numpy(self._eval_forward(x)))
        if stack_outputs:
            return np.concatenate(outs, axis=0)
        return outs

    def train_batch(self, inputs, labels=None, update=True):
        assert self._train_step is not None, "call prepare() first"
        loss = self._train_step(inputs, labels)
        return [float(loss)]

    def _input(self, a):
        return torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a, device=self.device)

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        with torch.no_grad(), self._autocast():
            out = self.network(self._input(inputs))
            if self._loss is not None and labels is not None:
                return [float(self._loss(out, self._input(labels)))]
        return out

    def predict_batch(self, inputs):
        """One batch forward in eval mode: a list of numpy outputs."""
        self.network.eval()
        with torch.no_grad(), self._autocast():
            out = self.network(self._input(inputs))
        outs = out if isinstance(out, (list, tuple)) else [out]
        return [_numpy(o) for o in outs]

    # ------------------------------------------------------- checkpoints --
    def _param_names(self):
        """The name of each of the optimizer's parameters, in its order."""
        by_id = {id(p): n for n, p in self.network.named_parameters()}
        return [by_id[id(p)] for p in self._optimizer._parameter_list]

    def save(self, path, training=True):
        """`path`.pdparams (and `path`.pdopt with the optimizer's state),
        in the reference's format and layout (framework_io), which the
        reference's Model.load reads."""
        framework_io.save(
            framework_io.module_state_to_paddle_tpu(self.network),
            path + ".pdparams")
        if training and self._optimizer is not None:
            framework_io.save(framework_io.transpose_optimizer_state(
                self._optimizer.state_dict(), self._param_names(),
                framework_io.linear_weight_names(self.network)),
                path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Read `path`.pdparams (and .pdopt) as written by either
        package's Model.save; the train step resumes at the optimizer's
        global_step."""
        sd = framework_io.load(path + ".pdparams")
        self.network.load_state_dict(
            framework_io.module_state_from_paddle_tpu(self.network, sd))
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(
                framework_io.transpose_optimizer_state(
                    framework_io.load(path + ".pdopt"), self._param_names(),
                    framework_io.linear_weight_names(self.network)))
            if self._train_step is not None:
                # the step's count drives Adam's bias correction: resume it
                self._train_step._host_step = self._optimizer._global_step

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        from .summary import summary

        return summary(self.network, input_size, dtype)
