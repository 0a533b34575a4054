"""Comparison, logical and bitwise ops (counterpart of
paddle_tpu/ops/logic.py). Both operands are tensors here: a Python
scalar becomes one as `to_tensor` makes it (1.5 a float32, 2 an int64),
then they promote as the reference's do."""
from __future__ import annotations

import torch

from ..core.dtype import is_complex as _dtype_is_complex
from .common import _t, promote


def _cmp(fn):
    def op(x, y, name=None):
        x = _t(x, y)
        y = _t(y, x)
        return fn(*promote(x, y))

    return op


equal = _cmp(torch.eq)
not_equal = _cmp(torch.ne)
less_than = _cmp(torch.lt)
less_equal = _cmp(torch.le)
greater_than = _cmp(torch.gt)
greater_equal = _cmp(torch.ge)
logical_and = _cmp(torch.logical_and)
logical_or = _cmp(torch.logical_or)
logical_xor = _cmp(torch.logical_xor)
bitwise_and = _cmp(torch.bitwise_and)
bitwise_or = _cmp(torch.bitwise_or)
bitwise_xor = _cmp(torch.bitwise_xor)


def logical_not(x, name=None):
    return torch.logical_not(_t(x))


def bitwise_not(x, name=None):
    return torch.bitwise_not(_t(x))


def _bool_tensor(v, like):
    return torch.tensor(bool(v), device=like.device)


def equal_all(x, y, name=None):
    x = _t(x, y)
    y = _t(y, x)
    if tuple(x.shape) != tuple(y.shape):
        return _bool_tensor(False, x)
    a, b = promote(x, y)
    return torch.eq(a, b).all()


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = _t(x, y)
    a, b = promote(x, _t(y, x))
    return _bool_tensor(torch.allclose(a, b, rtol=rtol, atol=atol,
                                       equal_nan=equal_nan), x)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x = _t(x, y)
    a, b = promote(x, _t(y, x))
    return torch.isclose(a, b, rtol=float(rtol), atol=float(atol),
                         equal_nan=equal_nan)


def is_empty(x, name=None):
    x = _t(x)
    return _bool_tensor(x.numel() == 0, x)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_complex(x):
    return _dtype_is_complex(_t(x).dtype)


def is_floating_point(x):
    return _t(x).dtype.is_floating_point


def is_integer(x):
    dt = _t(x).dtype
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)
