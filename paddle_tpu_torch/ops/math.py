"""Element-wise math ops (counterpart of paddle_tpu/ops/math.py).

Each op is a plain function on torch tensors with the reference's name,
arguments and result dtype (ops/common.py: Python scalars stay weak
operands; inexact ops take `to_inexact` of the promoted dtype).
"""
from __future__ import annotations

import torch

from ..core.dtype import convert_dtype
from ..core.tensor import to_tensor
from .common import (_operand, _t, as_dtype, device_of, promote,
                     result_type, scalar_value, to_inexact)


def _binary(fn, kind="promote"):
    """An op of two operands: both cast to their result dtype, which
    `kind` "inexact" takes to its inexact type and "numeric" takes from
    bool to int32 (JAX's promote_args_numeric)."""

    def op(x, y, name=None):
        if not isinstance(x, torch.Tensor) and \
                not isinstance(y, torch.Tensor):
            x = to_tensor(x)
        x, y = _operand(x, y), _operand(y, x)
        dt = result_type(x, y)
        if kind == "inexact":
            dt = to_inexact(dt)
        elif kind == "numeric" and dt == torch.bool:
            dt = torch.int32
        dev = device_of(x, y)
        return fn(as_dtype(x, dt, dev), as_dtype(y, dt, dev))

    return op


def _is_float(dt):
    return dt.is_floating_point or dt.is_complex


def _unary(fn, kind="inexact"):
    """An op of one tensor in its result dtype: "inexact" (bool and
    integers to float), "same", "numeric" (bool to int32) or "f64" (bool
    and integers to float64, as ops that mix in a Python float give)."""

    def op(x, name=None):
        x = _t(x)
        dt = x.dtype
        if kind == "inexact":
            dt = to_inexact(dt)
        elif kind == "numeric" and dt == torch.bool:
            dt = torch.int32
        elif kind == "f64" and not _is_float(dt):
            dt = torch.float64
        return fn(as_dtype(x, dt))

    return op


def _exact(fn):
    """`fn` on floats; integers and bools returned as they are (floor,
    ceil, round and trunc of an integer are the integer)."""
    return lambda x: fn(x) if _is_float(x.dtype) else x.clone()


add = _binary(torch.add)
subtract = _binary(torch.sub)
multiply = _binary(torch.mul)
mul = multiply


def divide(x, y, name=None):
    """True division; integer operands give float32 (the reference casts
    an integer result type to float32 after dividing in its inexact
    type)."""
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = to_tensor(x)
    x, y = _operand(x, y), _operand(y, x)
    dt = result_type(x, y)
    dev = device_of(x, y)
    ct = to_inexact(dt)
    out = torch.div(as_dtype(x, ct, dev), as_dtype(y, ct, dev))
    if not (_is_float(dt) or dt == torch.bool):
        out = out.to(torch.float32)
    return out


floor_divide = _binary(torch.floor_divide, "numeric")
remainder = _binary(torch.remainder, "numeric")
mod = remainder
floor_mod = remainder
pow = _binary(torch.pow, "numeric")
maximum = _binary(torch.maximum)
minimum = _binary(torch.minimum)
fmax = _binary(torch.fmax)
fmin = _binary(torch.fmin)
atan2 = _binary(torch.atan2, "inexact")
logaddexp = _binary(torch.logaddexp, "inexact")
hypot = _binary(torch.hypot, "inexact")
copysign = _binary(torch.copysign, "inexact")
heaviside = _binary(torch.heaviside, "inexact")
gcd = _binary(torch.gcd)
lcm = _binary(torch.lcm)
nextafter = _binary(torch.nextafter, "inexact")
inner = _binary(torch.inner)


def ldexp(x, y, name=None):
    """x * 2**y, y an integer tensor (its values read as int32)."""
    x = _t(x)
    y = _t(y, x)
    x = as_dtype(x, to_inexact(x.dtype))
    return torch.ldexp(x, y.to(torch.int32))


neg = _unary(torch.neg, "same")
abs = _unary(lambda x: x.clone() if x.dtype == torch.bool else torch.abs(x),
             "same")
exp = _unary(torch.exp)
expm1 = _unary(torch.expm1)
log = _unary(torch.log)
log2 = _unary(torch.log2)
log10 = _unary(torch.log10)
log1p = _unary(torch.log1p)
sqrt = _unary(torch.sqrt)
rsqrt = _unary(torch.rsqrt)
square = _unary(torch.square, "numeric")
sign = _unary(torch.sign, "same")
sin = _unary(torch.sin)
cos = _unary(torch.cos)
tan = _unary(torch.tan)
asin = _unary(torch.asin)
acos = _unary(torch.acos)
atan = _unary(torch.atan)
sinh = _unary(torch.sinh)
cosh = _unary(torch.cosh)
tanh = _unary(torch.tanh)
asinh = _unary(torch.asinh)
acosh = _unary(torch.acosh)
atanh = _unary(torch.atanh)
floor = _unary(_exact(torch.floor), "same")
ceil = _unary(_exact(torch.ceil), "same")
round = _unary(_exact(torch.round), "same")
trunc = _unary(_exact(torch.trunc), "same")
frac = _unary(lambda x: x - torch.trunc(x) if _is_float(x.dtype)
              else x - x, "same")
reciprocal = _unary(torch.reciprocal)
erf = _unary(torch.erf)
erfinv = _unary(torch.erfinv)
digamma = _unary(torch.digamma)
lgamma = _unary(torch.lgamma)
i0 = _unary(torch.special.i0)
i1 = _unary(torch.special.i1)
isnan = _unary(torch.isnan, "same")
isinf = _unary(torch.isinf, "same")
isfinite = _unary(torch.isfinite, "same")
conj = _unary(lambda x: torch.conj(x).resolve_conj()
              if x.is_complex() else x.clone(), "same")
real = _unary(lambda x: torch.real(x) if x.is_complex() else x.clone(),
              "same")
imag = _unary(lambda x: torch.imag(x) if x.is_complex()
              else torch.zeros_like(x), "same")
angle = _unary(torch.angle, "f64")
deg2rad = _unary(torch.deg2rad)
rad2deg = _unary(torch.rad2deg)


def clip(x, min=None, max=None, name=None):
    """x clamped to [min, max] (either may be None); Python bounds are
    weak operands of the result dtype."""
    min, max = scalar_value(min), scalar_value(max)
    x = _t(x)
    dt = result_type(x, min, max)
    x = as_dtype(x, dt)
    if min is not None:
        x = torch.maximum(x, as_dtype(min, dt, x.device))
    if max is not None:
        x = torch.minimum(x, as_dtype(max, dt, x.device))
    return x


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """x * scale + bias (or (x + bias) * scale), in x's dtype; a tensor
    `scale` promotes with x."""
    x = _t(x)
    if isinstance(scale, torch.Tensor):
        s, b = scale, float(bias)
        out = add(multiply(x, s), b) if bias_after_scale \
            else multiply(add(x, b), s)
    else:
        s = as_dtype(float(scale), x.dtype, x.device)
        b = as_dtype(float(bias), x.dtype, x.device)
        out = x * s + b if bias_after_scale else (x + b) * s
    if act is not None:
        from ..nn import functional as F

        out = getattr(F, act)(out)
    return out


def lerp(x, y, weight, name=None):
    """x + weight * (y - x), every operand a tensor (a Python weight is a
    float32 tensor, as the reference's to_tensor makes it)."""
    x = _t(x)
    x, y, w = promote(x, _t(y, x), _t(weight, x))
    return x + w * (y - x)


def logit(x, eps=None, name=None):
    x = _t(x)
    if eps is not None:
        x = clip(x, eps, 1.0 - eps)
    return log(divide(x, subtract(1.0, x)))


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    x = _t(x)
    if not _is_float(x.dtype):
        return x.clone()
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def add_n(inputs, name=None):
    if isinstance(inputs, torch.Tensor):
        inputs = [inputs]
    out = inputs[0]
    for v in inputs[1:]:
        out = add(out, v)
    return out


def _cum_dtype(x):
    # JAX's cumsum and cumprod take a bool to int64 and keep other dtypes
    return torch.int64 if x.dtype == torch.bool else x.dtype


def cumsum(x, axis=None, dtype=None, name=None):
    x = _t(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    out = torch.cumsum(x, int(axis), dtype=_cum_dtype(x))
    return out if dtype is None else out.to(convert_dtype(dtype))


def cumprod(x, dim=None, dtype=None, name=None):
    x = _t(x)
    if dim is None:
        x, dim = x.reshape(-1), 0
    out = torch.cumprod(x, int(dim), dtype=_cum_dtype(x))
    return out if dtype is None else out.to(convert_dtype(dtype))


def _cum_extreme(x, axis, dtype, running):
    """The running extreme and, as the reference forms it, the index of
    the last element equal to it so far."""
    x = _t(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % max(x.dim(), 1)
    values = running(x, axis).values
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    ar = torch.arange(x.shape[axis], device=x.device).reshape(shape)
    idx = torch.cummax(torch.where(x == values, ar, 0), axis).values
    return values, idx.to(convert_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, torch.cummax)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_extreme(x, axis, dtype, torch.cummin)


def _sum_dtype(dt):
    """The dtype of a sum or product (JAX's promote_integers): bool and
    signed integers to int64, unsigned to uint64."""
    if dt == torch.bool or dt in (torch.int8, torch.int16, torch.int32):
        return torch.int64
    if dt in (torch.uint8, torch.uint16, torch.uint32):
        return torch.uint64
    return dt


def _isum(x, dim, keepdim=False, fn=torch.sum):
    """`fn` (a sum) of x over dim in the sum dtype; a uint64 sum, which
    torch lacks, is taken in int64 and cast."""
    dt = _sum_dtype(x.dtype)
    if dt == torch.uint64:
        return fn(x, dim, keepdim=keepdim, dtype=torch.int64).to(dt)
    return fn(x, dim, keepdim=keepdim, dtype=dt)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    x = _t(x)
    d = torch.diagonal(x, offset=offset, dim1=axis1, dim2=axis2)
    return _isum(d, -1)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    x = as_dtype(x, to_inexact(x.dtype))
    if axis is None:
        axis = tuple(range(x.dim()))
    elif isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
    return torch.logsumexp(x, axis, keepdim=bool(keepdim))


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return multiply(tanh(multiply(_t(x), float(scale_a))), float(scale_b))


def rsqrt_(x):
    """In place: x = 1 / sqrt(x)."""
    return x.rsqrt_()


def increment(x, value=1.0, name=None):
    """x += value in place, x keeping its dtype."""
    with torch.no_grad():
        x.copy_(add(x, value))
    return x


def sgn(x, name=None):
    """x / |x| for complex x (0 at 0), sign(x) for real x."""
    x = _t(x)
    if x.is_complex():
        return torch.sgn(x)
    return torch.sign(x)
