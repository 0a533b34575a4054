"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` is the reference this package is held
against; nothing here imports it. Module names follow the reference so
each part can be found beside its counterpart. Plain tensor code is
PyTorch; every Pallas kernel of the reference on a ported path is a CUDA
kernel written for sm_90a (`ops/csrc/`).

A user's program reads as one written against the reference:

    import paddle_tpu_torch as paddle
    paddle.set_device("cpu")             # the card ("gpu:0") by default
    x = paddle.to_tensor([[1.0, 2.0]], stop_gradient=False)
    y = paddle.matmul(x, paddle.ones([2, 3]))
    paddle.mean(y).backward()

Tensors are torch.Tensors (`paddle.Tensor` is torch.Tensor) and every
op is a plain function on them with the reference's name, arguments,
defaults and result dtypes (ops/). Entry points and new tensors go to
the current place, the card unless `set_device("cpu")` or a `device=` /
`place=` argument names another; without a card they raise. `seed(s)`
reseeds the default key generator (core/rng.py) that the random ops,
dropout and `generate(do_sample=True)` draw from.

Subpackages (nn, optimizer, io, jit, ...) load when first named, so
that `import paddle_tpu_torch` stays light.
"""
from __future__ import annotations

import torch

# Pin the reference's numerics (paddle_tpu/__init__.py sets
# jax_default_matmul_precision="highest"): f32 products stay true f32,
# speed comes from explicit bf16 dtypes, never from TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .core.place import (CPUPlace, CUDAPlace, Place,  # noqa: E402,F401
                         TPUPlace, current_device, get_device,
                         is_compiled_with_cuda, resolve_device, set_device)

# the device an entry point uses when the caller names none
default_device = current_device

from .core.dtype import (bfloat16, bool_, complex64,  # noqa: E402,F401
                         complex128, float16, float32, float64, int8, int16,
                         int32, int64, uint8)
from .core.rng import seed  # noqa: E402,F401
from .core.tensor import to_tensor  # noqa: E402,F401
from .ops import *  # noqa: E402,F401,F403
from .ops import abs, all, any, max, min, pow, round, sum  # noqa: E402,F401

# Every name below this line may shadow a builtin (max, sum, abs, ...):
# the code here reaches the builtins through `builtins` only.
import builtins as _builtins  # noqa: E402

Tensor = torch.Tensor
CUDAPinnedPlace = CPUPlace
bool = bool_  # paddle.bool
dtype = torch.dtype
no_grad = torch.no_grad
enable_grad = torch.enable_grad
set_grad_enabled = torch.set_grad_enabled
is_grad_enabled = torch.is_grad_enabled

_default_dtype = float32
_static_mode = False


def get_default_dtype() -> str:
    from .core.dtype import dtype_to_str

    return dtype_to_str(_default_dtype)


def set_default_dtype(d):
    """The dtype the reference's framework reports as its default; as
    there, the creation ops keep their own defaults (float32)."""
    global _default_dtype
    from .core.dtype import convert_dtype

    _default_dtype = convert_dtype(d)
    return _default_dtype


def in_dynamic_mode() -> _builtins.bool:
    return not _static_mode


def enable_static():
    """Kept for parity: flips the mode flag `in_dynamic_mode` reports."""
    global _static_mode
    _static_mode = True


def disable_static():
    global _static_mode
    _static_mode = False


def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, only_inputs=True, allow_unused=False):
    """The gradients of `outputs` with respect to `inputs` (tensors or
    lists), leaving `.grad` untouched; an input the outputs do not reach
    raises unless `allow_unused`, which gives None for it."""
    outs = list(outputs) if isinstance(outputs, (list, tuple)) \
        else [outputs]
    ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None and not isinstance(grad_outputs,
                                                   (list, tuple)):
        grad_outputs = [grad_outputs]
    got = torch.autograd.grad(outs, ins, grad_outputs=grad_outputs,
                              retain_graph=retain_graph or create_graph,
                              create_graph=create_graph, allow_unused=True)
    for i, g in enumerate(got):
        if g is None and not allow_unused:
            raise ValueError(
                f"grad: input {i} is unreachable from the outputs; pass "
                f"allow_unused=True to get None for unused inputs")
    return list(got)


def create_parameter(shape, dtype="float32", name=None, attr=None,
                     is_bias=False, default_initializer=None):
    """A trainable tensor on the current place: zeros for a bias, else
    XavierNormal drawn from the default key generator, or zeros that
    `default_initializer(p)` then fills."""
    import math

    from .core import rng as _rng
    from .core.dtype import convert_dtype

    shape = [int(s) for s in shape]
    dt = convert_dtype(dtype)
    dev = current_device()
    if default_initializer is None and not is_bias:
        fan_in = shape[0] if shape else 1
        fan_out = shape[1] if len(shape) > 1 else 1
        denom = fan_in + fan_out if fan_in + fan_out > 0 else 1
        n = _rng.normal(_rng.next_key().to(dev), shape, torch.float64)
        data = (math.sqrt(2.0 / denom) * n).to(dt)
    else:
        data = torch.zeros(shape, dtype=dt, device=dev)
    p = torch.nn.Parameter(data)
    if default_initializer is not None:
        default_initializer(p)
    return p


def broadcast_shape(x_shape, y_shape):
    return list(torch.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def set_printoptions(precision=None, threshold=None, edgeitems=None,
                     sci_mode=None, linewidth=None):
    torch.set_printoptions(precision=precision, threshold=threshold,
                           edgeitems=edgeitems, linewidth=linewidth,
                           sci_mode=sci_mode)


def get_rng_state(device=None):
    """The default key generator's state, [(seed, counter)]."""
    from .core import rng as _rng

    return [_rng.default_generator().get_state()]


def set_rng_state(state_list, device=None):
    from .core import rng as _rng

    _rng.default_generator().set_state(tuple(state_list[0]))


def get_cuda_rng_state():
    return get_rng_state()


def set_cuda_rng_state(state_list):
    set_rng_state(state_list)


def disable_signal_handler():
    """Nothing to do: signal handling is Python's here."""


class LazyGuard:
    """Parameter-init deferral scope, kept for parity: parameters are
    made eagerly, so the guard changes nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def batch(reader, batch_size, drop_last=False):
    """A batch reader over a sample reader: lists of batch_size samples
    (the last one shorter unless drop_last)."""

    def batch_reader():
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) == batch_size:
                yield buf
                buf = []
        if buf and not drop_last:
            yield buf

    return batch_reader


def check_shape(shape):
    """Validate a shape argument: a non-empty list or tuple of ints
    (-1 allowed) or tensors, or a tensor."""
    if isinstance(shape, (list, tuple)):
        if not shape:
            raise ValueError("shape must not be empty")
        for s in shape:
            if not isinstance(s, (int, torch.Tensor)):
                raise TypeError(
                    f"shape element must be int/Tensor, got {type(s)}")
            if isinstance(s, int) and s < -1:
                raise ValueError(f"invalid dim {s} in shape")
    elif not isinstance(shape, torch.Tensor):
        raise TypeError("shape must be a list/tuple/Tensor")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def _lift_inplace(name):
    def fn(x, *args, **kwargs):
        return getattr(x, name)(*args, **kwargs)

    fn.__name__ = name
    fn.__doc__ = f"In-place variant (paddle.{name}): torch's own."
    return fn


# the reference's in-place variants whose torch method takes the
# reference's arguments (the rest wait: ROADMAP, queue 1 item 2)
for _n in ("exp_", "sqrt_", "reciprocal_", "ceil_", "floor_", "round_",
           "tanh_", "erfinv_", "remainder_", "lerp_", "sigmoid_", "zero_",
           "fill_", "masked_fill_"):
    globals()[_n] = _lift_inplace(_n)
del _n

# Subpackages and aliases resolved when first named
_LAZY_ALIASES = {
    "Model": ("hapi", "Model"),
    "summary": ("hapi", "summary"),
    "flops": ("hapi", "flops"),
}
_SUBPACKAGES = ("nn", "optimizer", "amp", "io", "jit", "distributed",
                "vision", "metric", "hapi", "profiler", "static", "models",
                "inference", "observability", "quantization", "linalg",
                "framework_io", "callbacks", "regularizer", "autoscale",
                "testing")


def __getattr__(name):
    import importlib

    if name in _LAZY_ALIASES:
        modname, attr = _LAZY_ALIASES[name]
        obj = getattr(importlib.import_module(f".{modname}", __name__), attr)
        globals()[name] = obj
        return obj
    if name in _SUBPACKAGES:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name in ("save", "load"):
        fio = importlib.import_module(".framework_io", __name__)
        return getattr(fio, name)
    raise AttributeError(f"module 'paddle_tpu_torch' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY_ALIASES) | set(_SUBPACKAGES)
                  | {"save", "load"})


__version__ = "0.2.0"
