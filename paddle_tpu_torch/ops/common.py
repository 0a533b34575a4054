"""What the op modules share (counterpart of paddle_tpu/ops/common.py):
`cast`, `shape`, `rank`, `iinfo`, `finfo`, and the reference's dtype
rules.

The reference runs JAX with x64 on, so its result dtypes are JAX's:
operands promote to the least upper bound of JAX's promotion lattice,
where a Python int, float or complex is a *weak* operand that takes the
other side's dtype when it can (int32 + 2 is int32, bf16 + 1.5 is bf16)
and becomes int64, float64 or complex128 when it cannot (int32 + 1.5 is
float64); a Python bool is a strong bool tensor. Ops that need an inexact
result take `to_inexact` of the promoted dtype: bool and integers up to
32 bits go to float32, 64-bit integers to float64. torch's own promotion
differs (int32 + 1.5 is float32 there), so every op here casts its
operands to the reference's dtype before calling torch, and a weak scalar
is rounded to that dtype first, as JAX converts it.
"""
from __future__ import annotations

import numbers

import torch

from ..core.dtype import convert_dtype
from ..core.tensor import to_tensor

# JAX's promotion lattice (jax/_src/dtypes.py, not strict, x64): each
# type and the types immediately above it; i*, f*, c* are the weak types
_I, _F, _C = "i*", "f*", "c*"
_LATTICE = {
    torch.bool: [_I],
    _I: [torch.uint8, torch.int8],
    torch.uint8: [torch.int16, torch.uint16],
    torch.uint16: [torch.int32, torch.uint32],
    torch.uint32: [torch.int64, torch.uint64],
    torch.uint64: [_F],
    torch.int8: [torch.int16],
    torch.int16: [torch.int32],
    torch.int32: [torch.int64],
    torch.int64: [_F],
    _F: [torch.bfloat16, torch.float16, _C],
    torch.bfloat16: [torch.float32],
    torch.float16: [torch.float32],
    torch.float32: [torch.float64, torch.complex64],
    torch.float64: [torch.complex128],
    _C: [torch.complex64],
    torch.complex64: [torch.complex128],
    torch.complex128: [],
}


def _upper_bounds():
    ub = {n: {n} for n in _LATTICE}
    changed = True
    while changed:
        changed = False
        for n in _LATTICE:
            more = set().union(*(_LATTICE[b] for b in ub[n])) - ub[n]
            if more:
                ub[n] |= more
                changed = True
    return ub


_UB = _upper_bounds()
# a weak result is materialized as x64's default types
_WEAK_DEFAULT = {_I: torch.int64, _F: torch.float64, _C: torch.complex128}
_INEXACT = {torch.bool: torch.float32, torch.uint8: torch.float32,
            torch.int8: torch.float32, torch.uint16: torch.float32,
            torch.int16: torch.float32, torch.uint32: torch.float32,
            torch.int32: torch.float32, torch.uint64: torch.float64,
            torch.int64: torch.float64}


def _node(x):
    if isinstance(x, torch.Tensor):
        return x.dtype
    if isinstance(x, bool):
        return torch.bool
    if isinstance(x, numbers.Integral):
        return _I
    if isinstance(x, numbers.Real):
        return _F
    if isinstance(x, numbers.Complex):
        return _C
    raise TypeError(f"not an operand: {type(x).__name__}")


def _lub(nodes):
    nodes = set(nodes)
    common = set.intersection(*(_UB[n] for n in nodes))
    least = [n for n in common if _UB[n] == common]
    if len(least) != 1:
        raise TypeError(f"no common dtype for {sorted(map(str, nodes))}")
    return least[0]


def result_type(*operands) -> torch.dtype:
    """The reference's (JAX's) result dtype of tensors and Python scalars;
    None operands are left out."""
    node = _lub(_node(x) for x in operands if x is not None)
    return _WEAK_DEFAULT.get(node, node)


def to_inexact(dtype: torch.dtype) -> torch.dtype:
    return _INEXACT.get(dtype, dtype)


def device_of(*xs, default=None):
    """The device of the first tensor among `xs` (or `default`)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return default


def _t(x, like=None):
    """A tensor as it is; anything else through `to_tensor`, on `like`'s
    device when `like` is a tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return to_tensor(x, place=like.device if isinstance(
        like, torch.Tensor) else None)


def _operand(x, like=None):
    """Python ints, floats and complexes stay weak scalars; everything
    else becomes a tensor."""
    if isinstance(x, (torch.Tensor, numbers.Number)) and \
            not isinstance(x, bool):
        return x
    return _t(x, like)


def as_dtype(x, dtype, device=None):
    """`x` in `dtype`: a tensor cast (the cast is differentiable); a
    scalar as a 0-d tensor of `dtype` on `device`, rounded to `dtype` as
    JAX converts a weak operand."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == dtype else x.to(dtype)
    return torch.full((), x, dtype=dtype, device=device)


def promote(*xs, inexact=False):
    """`xs` (tensors or scalars) cast to their reference result dtype (or
    its inexact type) on the first tensor's device."""
    dt = result_type(*xs)
    if inexact:
        dt = to_inexact(dt)
    dev = device_of(*xs)
    return [as_dtype(x, dt, dev) for x in xs]


def scalar_value(v):
    """A Python number from a number or a one-element tensor."""
    return v.item() if isinstance(v, torch.Tensor) else v


def cast(x, dtype, name=None):
    """Differentiable dtype cast (its gradient is cast back)."""
    x = _t(x)
    return x.to(convert_dtype(dtype))


def shape(x, name=None):
    """The shape as an int64 tensor on x's device."""
    x = _t(x)
    return torch.tensor(list(x.shape), dtype=torch.int64, device=x.device)


def rank(x, name=None):
    x = _t(x)
    return torch.tensor(x.dim(), dtype=torch.int32, device=x.device)


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))
