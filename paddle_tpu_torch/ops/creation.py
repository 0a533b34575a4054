"""Creation ops (counterpart of paddle_tpu/ops/creation.py).

New tensors go to the current place (core/place.py); with the card as
the current place and no card present they raise. The reference's
default dtypes hold: `full` takes bool, int64 or float32 from its fill
value and `arange` int64, or float32 when a bound is a float.

The random ops draw one key each from the default generator
(core/rng.py) and hash it on the tensor's device, as the reference's
`jax.random` calls do, so that a seeded sequence of them draws the
reference's values: the uniform draws in [0, 1), the integer,
permutation, Bernoulli and categorical draws bitwise; a uniform scaled
into [min, max) within a unit in the last place (XLA's CPU code fuses
the scale and shift into one multiply-add in some lanes); the normals,
through torch's erfinv, within a few units in the last place.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import rng as _rng
from ..core.dtype import convert_dtype
from ..core.place import current_device
from .common import _t, as_dtype, result_type, scalar_value, to_inexact
from .math import add, multiply


def _shape_list(shape):
    if isinstance(shape, torch.Tensor):
        shape = shape.tolist()
    if isinstance(shape, (int, np.integer)):
        shape = [shape]
    return tuple(int(scalar_value(s)) for s in shape)


def _dtype(dtype, default=torch.float32):
    return convert_dtype(dtype) or default


def zeros(shape, dtype="float32", name=None):
    return torch.zeros(_shape_list(shape), dtype=_dtype(dtype),
                       device=current_device())


def ones(shape, dtype="float32", name=None):
    return torch.ones(_shape_list(shape), dtype=_dtype(dtype),
                      device=current_device())


def full(shape, fill_value, dtype=None, name=None):
    fill_value = scalar_value(fill_value)
    if dtype is None:
        dtype = ("bool" if isinstance(fill_value, bool)
                 else "int64" if isinstance(fill_value, int) else "float32")
    return torch.full(_shape_list(shape), fill_value,
                      dtype=convert_dtype(dtype), device=current_device())


def empty(shape, dtype="float32", name=None):
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    x = _t(x)
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    x = _t(x)
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    x = _t(x)
    return torch.full_like(x, scalar_value(fill_value),
                           dtype=convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    for v in (start, end, step):
        if isinstance(v, torch.Tensor):
            raise TypeError("arange with tensor bounds: pass Python scalars")
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("float32" if any(isinstance(v, float)
                                  for v in (start, end, step)) else "int64")
    dtype = convert_dtype(dtype)
    # numpy's arange (the reference's, for concrete bounds): its length,
    # then the values in the dtype
    values = np.arange(start, end, step, dtype=np.dtype(str(dtype)[6:])
                       if dtype != torch.bfloat16 else np.float32)
    return torch.from_numpy(values).to(device=current_device(), dtype=dtype)


def linspace(start, stop, num, dtype="float32", name=None):
    """`num` values from start to stop in the inexact type of dtype
    (integer dtypes floored), as the reference's XLA program forms them:
    start * (1 - i * r) + i * (stop * r) with r = 1 / (num - 1), the
    last value stop itself. (XLA's CPU code also contracts some lanes of
    that into fused multiply-adds, so the reference's own values can
    differ from these in the last place.)"""
    start, stop, num = (scalar_value(v) for v in (start, stop, num))
    dt = convert_dtype(dtype)
    out = _linspace(start, stop, int(num), to_inexact(dt), current_device())
    if not (dt.is_floating_point or dt.is_complex):
        out = torch.floor(out)
    return out.to(dt)


def _linspace(start, stop, num, dtype, device):
    a = torch.as_tensor(start, dtype=dtype, device=device)
    b = torch.as_tensor(stop, dtype=dtype, device=device)
    if num > 1:
        r = 1 / torch.tensor(num - 1, dtype=dtype)
        i = torch.arange(num - 1, dtype=dtype, device=device)
        r = r.to(device)
        return torch.cat([a * (1 - i * r) + i * (b * r), b.reshape(1)])
    if num == 1:
        return a.reshape(1)
    return torch.empty(0, dtype=dtype, device=device)


def logspace(start, stop, num, base=10.0, dtype="float32", name=None):
    """JAX's logspace: base ** linspace(start, stop, num) in the
    computation type, then cast to dtype."""
    dt = convert_dtype(dtype)
    ct = to_inexact(dt)
    lin = linspace(start, stop, num, dtype=ct)
    out = torch.pow(torch.tensor(base, dtype=ct, device=lin.device), lin)
    return out.to(dt)


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    num_columns = num_rows if num_columns is None else num_columns
    return torch.eye(int(num_rows), int(num_columns), dtype=_dtype(dtype),
                     device=current_device())


def tril(x, diagonal=0, name=None):
    return torch.tril(_t(x), diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(_t(x), diagonal)


def diag(x, offset=0, padding_value=0, name=None):
    x = _t(x)
    out = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(mask, out, as_dtype(padding_value, out.dtype,
                                              out.device))
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(_t(x), offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(_t(x), offset, dim1, dim2)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(_t(x), offset, axis1, axis2)


def meshgrid(*args, **kwargs):
    tensors = args[0] if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else args
    return list(torch.meshgrid(*tensors, indexing="ij"))


def clone(x, name=None):
    return torch.clone(_t(x))


def assign(x, output=None):
    val = x.detach().clone() if isinstance(x, torch.Tensor) else _t(x)
    if output is not None:
        with torch.no_grad():
            output.copy_(val)
        return output
    return val


def tolist(x):
    return x.tolist()


def complex(real, imag, name=None):
    real, imag = _t(real), _t(imag)
    dt = result_type(real, imag, 1j)
    part = torch.float64 if dt == torch.complex128 else torch.float32
    return torch.complex(real.to(part), imag.to(part))


def as_complex(x, name=None):
    x = _t(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    x = _t(x)
    return torch.stack([torch.real(x), torch.imag(x)], dim=-1)


# --------------------------------------------------------------- random ----
def _key(device):
    return _rng.next_key().to(device)


def rand(shape, dtype="float32", name=None):
    dev = current_device()
    return _rng.uniform(_key(dev), _shape_list(shape), 0.0, 1.0,
                        _dtype(dtype))


def randn(shape, dtype="float32", name=None):
    dev = current_device()
    return _rng.normal(_key(dev), _shape_list(shape), _dtype(dtype))


def standard_normal(shape, dtype="float32", name=None):
    return randn(shape, dtype=dtype)


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    """Uniform in [min, max); a nonzero `seed` keys this draw alone
    (key(seed)), leaving the default generator as it is."""
    dev = current_device()
    k = _rng.key(seed).to(dev) if seed else _key(dev)
    return _rng.uniform(k, _shape_list(shape), float(min), float(max),
                        _dtype(dtype))


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """mean + std * a standard normal; with a tensor mean or std the
    normal is float64 of their broadcast shape (the reference draws it
    in its x64 default), else float32 of `shape`."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        dev = mean.device if isinstance(mean, torch.Tensor) else std.device
        shp = torch.broadcast_shapes(tuple(getattr(mean, "shape", ())),
                                     tuple(getattr(std, "shape", ())))
        n = _rng.normal(_key(dev), shp, torch.float64)
        return add(mean, multiply(std, n))
    dev = current_device()
    n = _rng.normal(_key(dev), _shape_list(shape or [1]), torch.float32)
    return mean + std * n


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = current_device()
    return _rng.randint(_key(dev), _shape_list(shape), int(low), int(high),
                        _dtype(dtype, torch.int64))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    return randint(low, high, tuple(x.shape), dtype or "int64")


def randperm(n, dtype="int64", name=None):
    dev = current_device()
    return _rng.permutation(_key(dev), int(n)).to(convert_dtype(dtype))


def bernoulli(x, name=None):
    """1 where a uniform of x's dtype falls below x, in x's dtype."""
    x = _t(x)
    u = _rng.uniform(_key(x.device), tuple(x.shape), 0.0, 1.0, x.dtype)
    return (u < x).to(x.dtype)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Indices drawn by the Gumbel-max trick over log(x): with
    replacement as jax.random.categorical draws them (noise of x's dtype
    over [num_samples, ...categories]); without, the top num_samples of
    log(x) plus float64 noise (ties: the lower index first)."""
    x = _t(x)
    logits = torch.log(torch.clamp(x, min=1e-30))
    k = _key(x.device)
    if replacement:
        shape = (*logits.shape[:-1], int(num_samples))
        batch = logits.shape[:-1]
        prefix = shape[:len(shape) - len(batch)]
        inner = list(shape[len(prefix):])
        inner.insert(len(inner), logits.shape[-1])
        g = _rng.gumbel(k, (*prefix, *inner), logits.dtype)
        lg = logits.reshape((1,) * len(prefix) + tuple(logits.shape))
        out = torch.argmax(g + lg, dim=-1)
    else:
        g = _rng.gumbel(k, tuple(logits.shape), torch.float64)
        z = logits.to(torch.float64) + g
        out = torch.sort(z, dim=-1, descending=True,
                         stable=True).indices[..., :int(num_samples)]
    return out.to(torch.int64)


def poisson(x, name=None):
    """A Poisson draw per element with rate x, in x's dtype
    (jax.random.poisson's algorithms, core/rng.py)."""
    x = _t(x)
    return _rng.poisson(_key(x.device), x).to(x.dtype)


def polar(abs, angle, name=None):
    """abs * exp(i * angle): complex128 for a float64 abs, else
    complex64."""
    a, th = _t(abs), _t(angle)
    dt = torch.float64 if a.dtype == torch.float64 else torch.float32
    re = (a * torch.cos(th)).to(dt)
    im = (a * torch.sin(th)).to(dt)
    return torch.complex(re, im)


def tril_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.tril_indices(int(row), int(col), int(offset),
                              device=current_device()).to(
        convert_dtype(dtype))


def triu_indices(row, col=None, offset=0, dtype="int64"):
    col = row if col is None else col
    return torch.triu_indices(int(row), int(col), int(offset),
                              device=current_device()).to(
        convert_dtype(dtype))


def fill_constant(shape, dtype, value, out=None, name=None):
    t = full(shape, value, dtype=dtype)
    if out is not None:
        with torch.no_grad():
            out.copy_(t)
        return out
    return t


def create_tensor(dtype, name=None, persistable=False):
    return torch.zeros((0,), dtype=convert_dtype(dtype),
                       device=current_device())
