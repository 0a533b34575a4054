"""Optimizers (counterpart of paddle_tpu/optimizer/optimizer.py).

Written by hand because torch.optim keeps no f32 master copy of a bf16
parameter and none of its optimizers computes the reference's update.
Each optimizer's `_update(p, g, st, lr, step, decay)` is the reference's
`_update` for one parameter: it updates `p` in place and its state `st`
(f32 moments and, under `multi_precision`, the f32 master of a bf16
parameter). Scalars are rounded as the reference's weakly typed Python
scalars are, to the dtype of the array they meet.

The base class holds what the reference's does:
- `learning_rate` is a float or an `lr.LRScheduler` (`get_lr`, `set_lr`);
- `weight_decay` is a float (L2), `L2Decay(c)` or `L1Decay(c)`, added to
  the gradient (`_apply_decay`) except by AdamW and Lamb, which decay the
  parameter themselves;
- `_should_decay(name)` gates decay by parameter name through
  `apply_decay_param_fun` (AdamW) or `exclude_from_weight_decay_fn`
  (Lamb). `parameters` may be tensors or (name, tensor) pairs; the train
  step gives the optimizer the model's names (the port's state_dict keys,
  which are the reference's), and an unnamed parameter i is `param_{i}`;
- `grad_clip` clips the grads before decay;
- `state_dict()` / `set_state_dict()` under the reference's keys
  (`global_step`, `p{i}.{moment}` by index in the parameter list,
  `LR_Scheduler`); `framework_io.transpose_optimizer_state` carries one
  across the packages' Linear layouts.
  The tensors are the live state, not copies.
"""
from __future__ import annotations

import numpy as np
import torch

from ..nn.functional import scalar_like
from .clip import ClipGradBase
from .lr import LRScheduler

_F32 = np.float32


class L2Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)


def _bias_correction(beta: float, step: int) -> float:
    """1 - beta**t in f32, t the f32 step, as the reference forms it."""
    return float(_F32(1) - _F32(beta) ** _F32(step))


class Optimizer:
    _decoupled = False      # AdamW and Lamb decay the parameter themselves

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None):
        if parameters is None:
            raise ValueError(
                "parameters required (pass model.parameters() or "
                "model.named_parameters())")
        self._parameter_list, self._names = [], []
        for item in parameters:
            n, p = item if isinstance(item, tuple) else (None, item)
            self._parameter_list.append(p)
            self._names.append(n)
        self._learning_rate = learning_rate
        self._grad_clip: ClipGradBase | None = grad_clip
        if isinstance(weight_decay, (L2Decay, L1Decay)):
            self._weight_decay = weight_decay.coeff
            self._decay_mode = "l1" if isinstance(weight_decay, L1Decay) \
                else "l2"
        else:
            self._weight_decay = float(weight_decay) if weight_decay else 0.0
            self._decay_mode = "l2"
        self.state = {}             # parameter -> its state dict
        self._global_step = 0

    # ------------------------------------------------------------ LR ------
    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        return self._learning_rate if isinstance(self._learning_rate,
                                                 LRScheduler) else None

    # ------------------------------------------------------- the update --
    def _init_state(self, p: torch.Tensor) -> dict:
        return {}

    def _update(self, p, g, st, lr, step, decay=True):
        raise NotImplementedError

    def _apply_decay(self, p, g):
        """Coupled decay: the gradient plus coeff * p (L2) or coeff *
        sign(p) (L1), in the reference's dtypes."""
        if not self._weight_decay:
            return g
        t = p if self._decay_mode == "l2" else torch.sign(p)
        return g + scalar_like(t, self._weight_decay) * t

    def _should_decay(self, name: str) -> bool:
        fn = getattr(self, "_apply_decay_param_fun", None)
        if fn is not None:
            return bool(fn(name))
        ex = getattr(self, "_exclude_from_weight_decay_fn", None)
        if ex is not None:
            return not bool(ex(name))
        return True

    def set_param_names(self, names: dict):
        """Name the parameters ({parameter: name}) for `_should_decay`;
        the train step gives the model's."""
        self._names = [names.get(p) for p in self._parameter_list]

    def _name(self, i: int) -> str:
        return self._names[i] or f"param_{i}"

    @torch.no_grad()
    def _apply(self, items, lr: float, step: int):
        """Update each (index, parameter, grad) of `items`, their grads
        clipped in the order given, at learning rate `lr` and step `step`
        (Adam's bias correction)."""
        if self._grad_clip is not None:
            clipped = self._grad_clip([(p, g) for _, p, g in items])
            items = [(i, p, g) for (i, p, _), (_, g) in zip(items, clipped)]
        for i, p, g in items:
            st = self.state.get(p)
            if st is None:
                st = self.state[p] = self._init_state(p)
            dec = self._should_decay(self._name(i))
            if not self._decoupled and dec:
                g = self._apply_decay(p, g)
            self._update(p, g, st, lr, step, decay=dec)

    def step(self):
        """The eager update from each trainable parameter's `.grad`,
        clipped in parameter order, at step global_step + 1."""
        items = [(i, p, p.grad) for i, p in enumerate(self._parameter_list)
                 if p.requires_grad and p.grad is not None]
        if items:
            self._apply(items, self.get_lr(), self._global_step + 1)
        self._global_step += 1

    def apply_gradients(self, named_grads: dict, lr: float, step: int):
        """The train step's update: `named_grads` {name: grad} of named
        parameters, clipped by sorted name (the reference's
        functional_update), at `lr` and `step`."""
        index = {n: i for i, n in enumerate(self._names)}
        items = [(index[n], self._parameter_list[index[n]], named_grads[n])
                 for n in sorted(named_grads)]
        self._apply(items, lr, step)

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad
    zero_grad = clear_grad

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    # -------------------------------------------------------- state dicts --
    def state_dict(self):
        sd = {"global_step": self._global_step}
        for i, p in enumerate(self._parameter_list):
            for k, v in self.state.get(p, {}).items():
                sd[f"p{i}.{k}"] = v
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    def set_state_dict(self, state_dict):
        self._global_step = int(state_dict.get("global_step", 0))
        if "LR_Scheduler" in state_dict and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state_dict["LR_Scheduler"])
        for i, p in enumerate(self._parameter_list):
            prefix = f"p{i}."
            st = {k[len(prefix):]: torch.as_tensor(v).to(p.device).clone()
                  for k, v in state_dict.items()
                  if isinstance(k, str) and k.startswith(prefix)}
            if st:
                self.state[p] = st


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)

    def _update(self, p, g, st, lr, step, decay=True):
        g = g.to(p.dtype)
        p.sub_(scalar_like(p, _F32(lr)) * g)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, p, g, st, lr, step, decay=True):
        g = g.to(p.dtype)
        mu = scalar_like(p, self._momentum)
        v = mu * st["velocity"] + g
        upd = g + mu * v if self._nesterov else v
        st["velocity"] = v
        p.sub_(scalar_like(p, _F32(lr)) * upd)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._multi_precision = bool(multi_precision)

    def _init_state(self, p):
        st = {"moment1": torch.zeros_like(p, dtype=torch.float32),
              "moment2": torch.zeros_like(p, dtype=torch.float32)}
        if self._multi_precision and p.dtype != torch.float32:
            st["master"] = p.detach().float()
        return st

    def _moments(self, g, st, step):
        """The f32 moments, updated in place; returns (mhat, vhat)."""
        g = g.float()
        m, v = st["moment1"], st["moment2"]
        m.mul_(self._beta1).add_((1 - self._beta1) * g)
        v.mul_(self._beta2).add_((1 - self._beta2) * g.square())
        return (m / _bias_correction(self._beta1, step),
                v / _bias_correction(self._beta2, step))

    @staticmethod
    def _master(p, st):
        """The f32 value the update works on: the master, the f32
        parameter itself, or an f32 copy of a low-precision one."""
        master = st.get("master")
        if master is None:
            master = p if p.dtype == torch.float32 else p.float()
        return master

    def _update(self, p, g, st, lr, step, decay=True):
        mhat, vhat = self._moments(g, st, step)
        master = self._master(p, st)
        master.sub_(lr * mhat / (vhat.sqrt_() + self._epsilon))
        if master is not p:
            p.copy_(master)


class AdamW(Adam):
    """Adam with decoupled weight decay, gated per parameter by
    `apply_decay_param_fun(name)`. `lr_ratio(param)` scales the learning
    rate of a parameter, decay included, as Paddle's AdamW does; the
    reference accepts it and leaves every rate as it is, so the two agree
    where it returns 1. The update is
        m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g^2        (f32 moments)
        mhat = m / (1 - b1^t); vhat = v / (1 - b2^t)       (t as f32)
        master = master*(1 - lr*wd) - lr*mhat/(sqrt(vhat) + eps)
    and the parameter is the master cast to its dtype."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode, multi_precision)
        self._lr_ratio = lr_ratio
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, p, g, st, lr, step, decay=True):
        if self._lr_ratio is not None:
            lr = lr * float(self._lr_ratio(p))
        mhat, vhat = self._moments(g, st, step)
        update = mhat / (vhat.sqrt_() + self._epsilon)
        wd = self._weight_decay if decay else 0.0
        master = self._master(p, st)
        master.mul_(float(_F32(1) - _F32(lr) * _F32(wd))).sub_(lr * update)
        if master is not p:
            p.copy_(master)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._init_acc = initial_accumulator_value

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_acc,
                                          dtype=torch.float32)}

    def _update(self, p, g, st, lr, step, decay=True):
        g = g.float()
        mom = st["moment"] + g.square()
        st["moment"] = mom
        p.copy_(p.float() - lr * g / (mom.sqrt() + self._epsilon))


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._epsilon = epsilon
        self._rho = rho

    def _init_state(self, p):
        return {"avg_sq_grad": torch.zeros_like(p, dtype=torch.float32),
                "avg_sq_update": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, st, lr, step, decay=True):
        g = g.float()
        rho, eps = self._rho, self._epsilon
        asg = rho * st["avg_sq_grad"] + (1 - rho) * g.square()
        upd = g * (st["avg_sq_update"] + eps).sqrt() / (asg + eps).sqrt()
        st["avg_sq_update"] = rho * st["avg_sq_update"] + \
            (1 - rho) * upd.square()
        st["avg_sq_grad"] = asg
        p.copy_(p.float() - lr * upd)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _init_state(self, p):
        st = {"mean_square": torch.zeros_like(p, dtype=torch.float32),
              "momentum": torch.zeros_like(p, dtype=torch.float32)}
        if self._centered:
            st["mean_grad"] = torch.zeros_like(p, dtype=torch.float32)
        return st

    def _update(self, p, g, st, lr, step, decay=True):
        g = g.float()
        rho, eps = self._rho, self._epsilon
        ms = rho * st["mean_square"] + (1 - rho) * g.square()
        st["mean_square"] = ms
        if self._centered:
            mg = rho * st["mean_grad"] + (1 - rho) * g
            st["mean_grad"] = mg
            denom = (ms - mg.square() + eps).sqrt()
        else:
            denom = (ms + eps).sqrt()
        mom = self._momentum * st["momentum"] + lr * g / denom
        st["momentum"] = mom
        p.copy_(p.float() - mom)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p, dtype=torch.float32),
                "inf_norm": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, st, lr, step, decay=True):
        g = g.float()
        m = self._beta1 * st["moment"] + (1 - self._beta1) * g
        u = torch.maximum(self._beta2 * st["inf_norm"], g.abs())
        st["moment"], st["inf_norm"] = m, u
        rate = float(_F32(lr) / _F32(_bias_correction(self._beta1, step)))
        p.copy_(p.float() - rate * m / (u + self._epsilon))


class Lamb(Optimizer):
    """Layer-wise adaptive moments: the Adam step plus decoupled decay,
    scaled by ||p|| / ||step|| (1 where either is 0)."""

    _decoupled = True

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, parameters=None, grad_clip=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_from_weight_decay_fn = exclude_from_weight_decay_fn

    def _init_state(self, p):
        return {"moment1": torch.zeros_like(p, dtype=torch.float32),
                "moment2": torch.zeros_like(p, dtype=torch.float32)}

    def _update(self, p, g, st, lr, step, decay=True):
        g, pf = g.float(), p.float()
        m = self._beta1 * st["moment1"] + (1 - self._beta1) * g
        v = self._beta2 * st["moment2"] + (1 - self._beta2) * g.square()
        st["moment1"], st["moment2"] = m, v
        mhat = m / _bias_correction(self._beta1, step)
        vhat = v / _bias_correction(self._beta2, step)
        wd = self._weight_decay if decay else 0.0
        r = mhat / (vhat.sqrt() + self._epsilon) + wd * pf
        w_norm = pf.square().sum().sqrt()
        r_norm = r.square().sum().sqrt()
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.copy_(pf - lr * trust * r)


__all__ = ["L1Decay", "L2Decay", "Optimizer", "SGD", "Momentum", "Adam",
           "AdamW", "Adagrad", "Adadelta", "RMSProp", "Adamax", "Lamb"]
