"""Mixed precision (counterpart of paddle_tpu/amp).

O2 (`decorate`) casts the model's parameters to the AMP dtype; the
optimizer keeps the f32 masters. O1 (`auto_cast`) leaves the parameters
in f32 and casts at the ops, by the reference's lists (`white_list()`,
`black_list()`; paddle_tpu/core/dispatch.py): a listed op's floating
inputs go to the AMP dtype (white: matmul, linear, einsum, attention,
...) or from it to f32 (black: layer_norm, cross_entropy, reductions,
...); every other op runs in the dtypes it is given, promoted as torch
and JAX both promote (bf16 + f32 is f32). The port has no dispatcher: the
ops of its GPT path ask `cast_inputs(op, ...)` themselves
(`nn.functional.linear`, `layer_norm`, the LM head's matmul), so under
O1 the GPT runs the reference's dtypes. torch.autocast's own op lists
are not the reference's and are not used.

`GradScaler` is the reference's dynamic loss scaler: `scale`,
`unscale_` (one finiteness check over all grads), `step` (skips the
update when a grad is not finite), `minimize`, `update` and
`state_dict`.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}

# the reference's O1 lists (paddle_tpu/core/dispatch.py:41-50), by op name
AMP_WHITE_LIST = {
    "matmul", "mm", "bmm", "einsum", "linear", "conv1d", "conv2d", "conv3d",
    "conv2d_transpose", "addmm", "attention", "flash_attention",
}
AMP_BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "pow", "square", "sqrt", "rsqrt",
    "softmax_with_cross_entropy", "cross_entropy", "log_softmax", "cumsum",
    "logsumexp", "erf", "erfinv", "sum", "mean", "norm", "cos_sim",
    "layer_norm",
}

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "AmpScaler",
           "white_list", "black_list", "cast_inputs"]


class _AutocastState(threading.local):
    enabled = False
    dtype = torch.bfloat16


_STATE = _AutocastState()


def white_list():
    return set(AMP_WHITE_LIST)


def black_list():
    return set(AMP_BLACK_LIST)


def _dtype(name):
    if name not in _DTYPES:
        raise ValueError(f"amp: unknown dtype {name!r}")
    return _DTYPES[name]


@contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Within the block, the listed ops cast their inputs (see the
    module's docstring); `custom_white_list` / `custom_black_list` add op
    names to the lists for the block. `level` O1 and O2 cast alike, as
    the reference's (O2's parameters are cast by `decorate`)."""
    prev = (_STATE.enabled, _STATE.dtype)
    added_w, added_b = set(), set()
    if enable:
        _STATE.enabled = True
        _STATE.dtype = _dtype(dtype)
        added_w = set(custom_white_list or ()) - AMP_WHITE_LIST
        added_b = set(custom_black_list or ()) - AMP_BLACK_LIST
        AMP_WHITE_LIST.update(added_w)
        AMP_BLACK_LIST.update(added_b)
    try:
        yield
    finally:
        _STATE.enabled, _STATE.dtype = prev
        AMP_WHITE_LIST.difference_update(added_w)
        AMP_BLACK_LIST.difference_update(added_b)


amp_guard = auto_cast


def cast_inputs(op: str, *tensors):
    """`tensors` as op `op` takes them under auto_cast: white-listed, f32
    tensors cast to the AMP dtype; black-listed, AMP-dtype tensors cast to
    f32; otherwise (or outside auto_cast) unchanged. None passes."""
    if not _STATE.enabled:
        return tensors
    if op in AMP_WHITE_LIST:
        src, dst = torch.float32, _STATE.dtype
    elif op in AMP_BLACK_LIST:
        src, dst = _STATE.dtype, torch.float32
    else:
        return tensors
    return tuple(t.to(dst) if t is not None and t.dtype == src else t
                 for t in tensors)


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast every floating parameter of the model(s), LayerNorm's
    included, to `dtype` (the optimizer keeps f32 masters under
    multi_precision); O1 leaves them. Returns the model(s), and the
    optimizer(s) when given, as the reference does."""
    dt = _dtype(dtype)
    if level not in ("O1", "O2"):
        raise ValueError(f"amp.decorate: unknown level {level!r}")
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dt)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


class GradScaler:
    """Dynamic loss scaling (the reference's rules): the loss is scaled by
    `scale`; `unscale_` multiplies every grad by 1/scale in its dtype and
    checks them all for inf/nan at once; `step` updates only when they are
    finite; then the scale halves (decr_ratio) after
    `decr_every_n_nan_or_inf` bad steps, floored at 1, or doubles
    (incr_ratio) after `incr_every_n_steps` good ones."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        finite = True
        if grads:
            inv = torch.tensor(1.0 / self._scale, dtype=torch.float32)
            flags = []
            for g in grads:
                g.mul_(inv.to(g.dtype))
                flags.append(torch.isfinite(g.float()).all())
            finite = bool(torch.stack(flags).all())
        self._found_inf = not finite
        self._unscaled = True

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        if not self._unscaled:
            self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update()
        self._unscaled = False

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        optimizer.clear_grad()

    def update(self):
        self._update()

    def _update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd["good_steps"]
        self._bad_steps = sd["bad_steps"]


AmpScaler = GradScaler
