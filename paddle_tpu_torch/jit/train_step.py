"""Train and eval steps (counterpart of paddle_tpu/jit/train_step.py,
its single-device `TrainStep` and `EvalStep`).

The reference compiles forward, backward and the update into one XLA
program; PyTorch runs them eagerly, one call after the other, with the
reference's semantics:
- one key a call from the default generator (`next_key()`), under which
  the forward's dropout draws (`rng_key_scope`);
- the learning rate read from `optimizer.get_lr()` every update, Adam's
  step the host step (the user steps an LR scheduler);
- the finiteness check of the loss and the f32-cast grads, before the
  update, when `FLAGS_check_nan_inf` or `skip_bad_steps` asks for it;
- `skip_bad_steps` (default `FLAGS_skip_nan_steps`): a non-finite step
  leaves parameters, masters, moments and the optimizer's global_step as
  they were (the host step still advances, as the reference's does);
  `bad_step_count`, `last_step_finite`;
- `accumulate_steps=k`: each call adds its grads to an f32 accumulator;
  every k-th call updates with acc / k (then the optimizer's clip). Under
  skip_bad_steps a micro-batch whose loss or grads are not finite is
  dropped whole (`bad_micro_count`), and a window of only such
  micro-batches skips its update (`bad_step_count`);
- the chaos site `step` (testing/chaos.py): `step:nan:K` multiplies the
  first floating batch element of the K-th call by NaN;
- the model's buffers (batch norm's running statistics) advance in the
  forward of every call, every micro-batch's under accumulation, as the
  reference's step carries them; under skip_bad_steps a step or
  micro-batch that is dropped puts them back as they were.
Meshes, ZeRO and LocalSGD are ROADMAP queue 5.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import rng as _rng
from ..core.flags import flag
from ..testing import chaos as _chaos

_QUEUE5 = "ROADMAP queue 5 (meshes, sharding and ZeRO)"


def _all_finite(loss, grads) -> torch.Tensor:
    """One device bool: the loss and every grad (cast to f32) finite."""
    flags = [torch.isfinite(g.float()).all() for g in grads]
    if loss is not None:
        flags.append(torch.isfinite(loss.float()).all())
    return torch.stack(flags).all()


class TrainStep:
    """step = TrainStep(model, optimizer, loss_fn); loss = step(*batch).

    loss_fn(model, *batch) -> scalar loss tensor; with loss_fn=None the
    model returns the loss. Batch elements may be tensors or arrays; they
    are moved to the model's device. Returns the detached loss."""

    def __init__(self, model, optimizer, loss_fn: Optional[Callable] = None,
                 mesh=None, shard_fn=None, batch_sharding=None,
                 donate: bool = True, zero_stage: int = 0,
                 dp_axis: str = "dp", accumulate_steps: int = 1,
                 param_sync_every: int = 0,
                 skip_bad_steps: Optional[bool] = None):
        for arg, val in (("mesh", mesh), ("shard_fn", shard_fn),
                         ("batch_sharding", batch_sharding)):
            if val is not None:
                raise NotImplementedError(f"TrainStep({arg}=...) is not "
                                          f"ported: {_QUEUE5}")
        if zero_stage or param_sync_every:
            raise NotImplementedError(f"TrainStep's ZeRO and LocalSGD are "
                                      f"not ported: {_QUEUE5}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.device = next(model.parameters()).device
        if skip_bad_steps is None:
            skip_bad_steps = bool(flag("skip_nan_steps"))
        self.skip_bad_steps = bool(skip_bad_steps)
        self.bad_step_count = 0
        self.bad_micro_count = 0
        self.last_step_finite = True
        self.last_lr = None
        self._acc_steps = int(accumulate_steps)
        self._grad_acc = None
        self._window_bad = 0          # micro-batches dropped this window
        self._micro = 0
        self._host_step = 0
        self._params = {n: p for n, p in model.named_parameters()
                        if p.requires_grad}
        self._buffers = [b for b in model.buffers() if b is not None]
        optimizer.set_param_names({p: n for n, p in
                                   model.named_parameters()})

    @staticmethod
    def _poison_nan(batch):
        """The chaos `step:nan` directive: the first floating batch
        element times NaN, in its dtype."""
        batch = list(batch)
        for i, v in enumerate(batch):
            if v.is_floating_point():
                batch[i] = v * torch.tensor(float("nan"), dtype=v.dtype)
                break
        return batch

    def _keep_buffers(self):
        """Copies of the buffers, for `_restore_buffers` after a dropped
        step; None when nothing can be dropped."""
        if not (self.skip_bad_steps and self._buffers):
            return None
        return [b.clone() for b in self._buffers]

    def _restore_buffers(self, kept):
        if kept is not None:
            with torch.no_grad():
                for b, k in zip(self._buffers, kept):
                    b.copy_(k)

    def _grads(self, key, batch):
        """Forward under the step key, backward; returns (loss, {name:
        grad}) and leaves no .grad behind."""
        with _rng.rng_key_scope(key):
            if self.loss_fn is not None:
                loss = self.loss_fn(self.model, *batch)
            else:
                loss = self.model(*batch)
        loss.backward()
        grads = {}
        for n, p in self._params.items():
            grads[n] = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
        return loss.detach(), grads

    def __call__(self, *batch):
        batch = [torch.as_tensor(x, device=self.device) for x in batch]
        check_nan = bool(flag("check_nan_inf"))
        if _chaos.active():
            # before the key is drawn, as the reference: a retried step
            # replays the same stream
            if _chaos.hit("step", step=self._host_step + 1) == "nan":
                batch = self._poison_nan(batch)
        key = _rng.next_key()
        if self._acc_steps > 1:
            return self._micro_step(key, batch, check_nan)

        self._host_step += 1
        lr = self.optimizer.get_lr()
        kept = self._keep_buffers()
        loss, grads = self._grads(key, batch)
        if check_nan or self.skip_bad_steps:
            finite = bool(_all_finite(loss, grads.values()))
        else:
            finite = True
        if finite or not self.skip_bad_steps:
            self._update(grads, lr)
        if not finite:
            self.last_step_finite = False
            if self.skip_bad_steps:
                self.bad_step_count += 1
                self._restore_buffers(kept)
            else:
                raise FloatingPointError(
                    f"FLAGS_check_nan_inf: nan/inf in loss or gradients at "
                    f"step {self._host_step}")
        else:
            self.last_step_finite = True
        return loss

    def _update(self, grads, lr):
        self.last_lr = lr
        self.optimizer.apply_gradients(grads, lr, self._host_step)
        self.optimizer._global_step = self._host_step

    def _micro_step(self, key, batch, check_nan):
        kept = self._keep_buffers()
        loss, grads = self._grads(key, batch)
        if self._grad_acc is None:
            self._grad_acc = {n: torch.zeros_like(p, dtype=torch.float32)
                              for n, p in self._params.items()}
        # under skip_bad_steps a poisoned micro-batch must not reach the
        # accumulator
        if self.skip_bad_steps and not bool(_all_finite(loss,
                                                        grads.values())):
            self._window_bad += 1
            self._restore_buffers(kept)
        else:
            for n, g in grads.items():
                self._grad_acc[n].add_(g.float())
        del grads
        self._micro += 1
        if self._micro % self._acc_steps:
            return loss
        self._host_step += 1
        bad, self._window_bad = self._window_bad, 0
        self.bad_micro_count += bad
        if bad == self._acc_steps:
            # every micro-batch dropped: an update on zero grads would
            # still move the parameters (decay, moments), so skip it
            self.bad_step_count += 1
            self._grad_acc = None
            self.last_step_finite = False
            return loss
        k = float(self._acc_steps)
        grads = {n: a / k for n, a in self._grad_acc.items()}
        self._grad_acc = None
        finite = True
        if check_nan or self.skip_bad_steps:
            finite = bool(_all_finite(None, grads.values()))
        if finite or not self.skip_bad_steps:
            self._update(grads, self.optimizer.get_lr())
        if not finite:
            self.last_step_finite = False
            if self.skip_bad_steps:
                self.bad_step_count += 1
            else:
                raise FloatingPointError(
                    f"FLAGS_check_nan_inf: nan/inf in accumulated "
                    f"gradients at step {self._host_step}")
        else:
            self.last_step_finite = True
        return loss


class EvalStep:
    """out = EvalStep(model)(*batch): the model in eval mode (no dropout)
    without autograd; the model's mode is put back after."""

    def __init__(self, model, mesh=None, batch_sharding=None):
        if mesh is not None or batch_sharding is not None:
            raise NotImplementedError(f"EvalStep's mesh is not ported: "
                                      f"{_QUEUE5}")
        self.model = model
        self.device = next(model.parameters()).device

    def __call__(self, *batch):
        batch = [torch.as_tensor(x, device=self.device) for x in batch]
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad():
                return self.model(*batch)
        finally:
            self.model.train(was_training)
