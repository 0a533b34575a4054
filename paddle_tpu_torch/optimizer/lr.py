"""LR schedulers (counterpart of paddle_tpu/optimizer/lr.py): plain
Python on the host, each lr the reference's float for the same epoch.

`state_dict()` holds the public attributes, as the reference's does,
less the callables (`lr_lambda`, `scale_fn`: construction arguments,
which no pickle can carry), and with a wrapped scheduler (LinearWarmup's
`lr_sched`) as its own state_dict; `set_state_dict` restores into the
wrapped scheduler the caller built."""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, learning_rate=0.1, last_epoch=-1, verbose=False):
        self.base_lr = float(learning_rate)
        self.last_epoch = last_epoch
        self.verbose = verbose
        self.last_lr = self.base_lr
        self.step()

    def __call__(self):
        return self.last_lr

    def step(self, epoch=None):
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_lr(self):
        raise NotImplementedError

    def state_dict(self):
        out = {}
        for k, v in self.__dict__.items():
            if k.startswith("_") or callable(v) and \
                    not isinstance(v, LRScheduler):
                continue
            out[k] = v.state_dict() if isinstance(v, LRScheduler) else v
        return out

    def set_state_dict(self, state_dict):
        for k, v in state_dict.items():
            inner = self.__dict__.get(k)
            if isinstance(inner, LRScheduler):
                inner.set_state_dict(v)
            else:
                self.__dict__[k] = v

    set_dict = set_state_dict
    state_keys = state_dict


class NoamDecay(LRScheduler):
    def __init__(self, d_model, warmup_steps, learning_rate=1.0,
                 last_epoch=-1, verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return self.base_lr * (self.d_model ** -0.5) * min(
            step ** -0.5, step * self.warmup_steps ** -1.5)


class PiecewiseDecay(LRScheduler):
    def __init__(self, boundaries, values, last_epoch=-1, verbose=False):
        self.boundaries = boundaries
        self.values = values
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for i, b in enumerate(self.boundaries):
            if self.last_epoch < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)


class InverseTimeDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)


class PolynomialDecay(LRScheduler):
    def __init__(self, learning_rate, decay_steps, end_lr=0.0001, power=1.0,
                 cycle=False, last_epoch=-1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(max(step, 1) / self.decay_steps)
            decay_steps = self.decay_steps * max(div, 1)
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return (self.base_lr - self.end_lr) * (
            (1 - step / decay_steps) ** self.power) + self.end_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 last_epoch=-1, verbose=False):
        self.lr_sched = learning_rate \
            if isinstance(learning_rate, LRScheduler) else None
        self.target = learning_rate if not self.lr_sched else None
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch, verbose)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / \
                self.warmup_steps + self.start_lr
        if self.lr_sched is not None:
            self.lr_sched.step(self.last_epoch - self.warmup_steps)
            return self.lr_sched()
        return self.target


class ExponentialDecay(LRScheduler):
    def __init__(self, learning_rate, gamma, last_epoch=-1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (self.gamma ** self.last_epoch)


class MultiStepDecay(LRScheduler):
    def __init__(self, learning_rate, milestones, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.milestones = milestones
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * (self.gamma ** n)


class StepDecay(LRScheduler):
    def __init__(self, learning_rate, step_size, gamma=0.1, last_epoch=-1,
                 verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * (
            self.gamma ** (self.last_epoch // self.step_size))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate, lr_lambda, last_epoch=-1, verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate, T_max, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate, T_0, T_mult=1, eta_min=0, last_epoch=-1,
                 verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = self.last_epoch
        ti = self.T_0
        while t >= ti:
            t -= ti
            ti *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t / ti)) / 2


class ReduceOnPlateau(LRScheduler):
    def __init__(self, learning_rate, mode="min", factor=0.1, patience=10,
                 threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0,
                 epsilon=1e-8, verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = float(learning_rate)
        self.last_lr = self.base_lr
        self.last_epoch = 0

    def get_lr(self):
        return self.last_lr

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        v = float(metrics)
        better = (self.best is None or
                  (self.mode == "min" and v < self.best - self.threshold) or
                  (self.mode == "max" and v > self.best + self.threshold))
        if better:
            self.best = v
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        elif self.num_bad > self.patience:
            self.last_lr = max(self.last_lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate, total_steps, divide_factor=25.0,
                 end_learning_rate=0.0001, phase_pct=0.3,
                 anneal_strategy="cos", three_phase=False, last_epoch=-1,
                 verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        super().__init__(self.initial_lr, last_epoch, verbose)

    def get_lr(self):
        up = int(self.total_steps * self.phase_pct)
        step = min(self.last_epoch, self.total_steps)
        if step <= up and up > 0:
            pct = step / up
            return self.initial_lr + (self.max_lr - self.initial_lr) * (
                1 - math.cos(math.pi * pct)) / 2
        pct = (step - up) / max(self.total_steps - up, 1)
        return self.end_lr + (self.max_lr - self.end_lr) * (
            1 + math.cos(math.pi * pct)) / 2


class MultiplicativeDecay(LRScheduler):
    """lr = lr * lr_lambda(epoch) cumulatively (reference optimizer/lr.py
    MultiplicativeDecay)."""

    def __init__(self, learning_rate, lr_lambda, last_epoch=-1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        cur = self.base_lr
        for e in range(1, self.last_epoch + 1):
            cur = cur * self.lr_lambda(e)
        return cur


class CyclicLR(LRScheduler):
    """Triangular cyclic LR (reference optimizer/lr.py CyclicLR): cycles
    between base_learning_rate and max_learning_rate with optional
    amplitude scaling per cycle or per step."""

    def __init__(self, base_learning_rate, max_learning_rate,
                 step_size_up, step_size_down=None, mode="triangular",
                 exp_gamma=1.0, scale_fn=None, scale_mode="cycle",
                 last_epoch=-1, verbose=False):
        self.max_lr = float(max_learning_rate)
        self.up = int(step_size_up)
        self.down = int(step_size_down) if step_size_down is not None \
            else int(step_size_up)
        self.mode = mode
        self.exp_gamma = exp_gamma
        if scale_fn is not None:
            self.scale_fn = scale_fn
            self.scale_mode = scale_mode
        elif mode == "triangular":
            self.scale_fn = lambda x: 1.0
            self.scale_mode = "cycle"
        elif mode == "triangular2":
            self.scale_fn = lambda x: 1.0 / (2.0 ** (x - 1))
            self.scale_mode = "cycle"
        elif mode == "exp_range":
            self.scale_fn = lambda x: exp_gamma ** x
            self.scale_mode = "iterations"
        else:
            raise ValueError(f"unknown CyclicLR mode {mode!r}")
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        it = max(self.last_epoch, 0)
        cycle = 1 + it // total
        x = it % total
        frac = x / self.up if x < self.up else 1 - (x - self.up) / self.down
        amp = (self.max_lr - self.base_lr) * frac
        scale = self.scale_fn(cycle if self.scale_mode == "cycle" else it)
        return self.base_lr + amp * scale
