"""Products and statistics of linear algebra (counterpart of the first
part of paddle_tpu/ops/linalg.py): matmul and its forms, einsum, norms,
cross, histograms, bincount, cov, corrcoef and cos_sim. The
factorizations and solves are not ported yet.

Integer and bool products run as a broadcast multiply and sum over
blocks of K on the card, whose GEMMs take no integer types (bool as a
logical or of ands, as the reference gives it)."""
from __future__ import annotations

import torch

from .common import _t, as_dtype, promote, to_inexact
from .extras import histogramdd
from .math import _isum, add, divide, multiply, subtract
from .math import pow as _pow


# elements of the product's temporary [..., M, k-block, N]: a block of
# K at a time keeps it bounded (128 MiB of int64)
_INT_MATMUL_BLOCK = 1 << 24


def _int_matmul(x, y):
    """x @ y for integer or bool operands of one dtype (numpy's matmul
    rules for 1-D operands), accumulated over blocks of K so that the
    broadcast product never holds more than _INT_MATMUL_BLOCK
    elements. Integer sums wrap in the operands' width, as XLA's dot
    does; a bool product is a logical or of ands."""
    xv = x[None] if x.dim() == 1 else x
    yv = y[:, None] if y.dim() == 1 else y
    (m, k), n = xv.shape[-2:], yv.shape[-1]
    batch = torch.broadcast_shapes(xv.shape[:-2], yv.shape[:-2])
    out = torch.zeros((*batch, m, n), dtype=x.dtype, device=x.device)
    kb = max(1, _INT_MATMUL_BLOCK // max(1, out.numel()))
    for k0 in range(0, k, kb):
        xs = xv[..., :, k0:k0 + kb, None]
        ys = yv[..., None, k0:k0 + kb, :]
        if x.dtype == torch.bool:
            out |= (xs & ys).any(-2)
        else:
            out += (xs * ys).sum(-2, dtype=x.dtype)
    if x.dim() == 1:
        out = out.squeeze(-2)
    if y.dim() == 1:
        out = out.squeeze(-1)
    return out


def _mm(x, y):
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return torch.matmul(x, y)
    return _int_matmul(x, y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x = _t(x, y)
    x, y = promote(x, _t(y, x))
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return _mm(x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def dot(x, y, name=None):
    """sum(x * y) over the last axis (an integer sum in int64)."""
    x = _t(x, y)
    x, y = promote(x, _t(y, x))
    return _isum(x * y, -1)


def mv(x, vec, name=None):
    return matmul(x, vec)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return add(multiply(float(beta), _t(input)),
               multiply(float(alpha), matmul(x, y)))


def einsum(equation, *operands):
    xs = promote(*(_t(o) for o in operands)) if len(operands) > 1 else \
        [_t(operands[0])]
    return torch.einsum(equation, *xs)


def multi_dot(x, name=None):
    xs = promote(*(_t(v) for v in x))
    if xs[0].dtype.is_floating_point or xs[0].dtype.is_complex:
        return torch.linalg.multi_dot(xs)
    out = xs[0]
    for v in xs[1:]:
        out = _int_matmul(out, v)
    return out


def matrix_power(x, n, name=None):
    """x to the integer power n by repeated squaring, as
    jnp.linalg.matrix_power forms it (n < 0 needs the inverse, which
    waits with the solves)."""
    x = _t(x)
    n = int(n)
    if n < 0:
        raise NotImplementedError("matrix_power with n < 0 needs the matrix "
                                  "inverse, which is not ported yet")
    if n == 0:
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        return torch.broadcast_to(eye, x.shape).clone()
    z = result = None
    while n > 0:
        z = x if z is None else _mm(z, z)
        n, bit = divmod(n, 2)
        if bit:
            result = z if result is None else _mm(result, z)
    return result


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    """A vector norm over `axis` (all elements for None): "fro" and 2 as
    sqrt(sum(x**2)), inf and -inf the max and min of |x|, 0 the count of
    nonzeros, else (sum |x|**p)**(1/p); a matrix norm over a pair of
    axes (2 and "fro" as the Frobenius norm, as the reference takes
    them)."""
    x = _t(x)
    if not isinstance(p, str):
        p = float(p)
    keepdim = bool(keepdim)
    if isinstance(axis, (list, tuple)):
        axis = tuple(int(a) for a in axis)
        if p in ("fro", 2.0):
            return _sqrt(_isum(_square(x), axis, keepdim))
        return torch.linalg.matrix_norm(
            as_dtype(x, to_inexact(x.dtype)), ord=p, dim=axis,
            keepdim=keepdim)
    if axis is None:
        x, axis = x.reshape(-1), 0
    if p == "fro":
        return _sqrt(_isum(_square(x), axis, keepdim))
    if p == float("inf"):
        return torch.amax(torch.abs(x), axis, keepdim=keepdim)
    if p == float("-inf"):
        return torch.amin(torch.abs(x), axis, keepdim=keepdim)
    if p == 0:
        return _isum((x != 0).to(x.dtype), axis, keepdim)
    s = _pow(torch.abs(x), p)
    return _pow(torch.sum(s, axis, keepdim=keepdim), 1.0 / p)


def _square(x):
    return torch.square(x.to(torch.int32) if x.dtype == torch.bool else x)


def _sqrt(x):
    return torch.sqrt(as_dtype(x, to_inexact(x.dtype)))


def dist(x, y, p=2, name=None):
    return norm(subtract(_t(x, y), _t(y, x)), p=float(p))


def cross(x, y, axis=9, name=None):
    """The cross product along `axis`; the default 9 means the first axis
    of size 3."""
    x = _t(x, y)
    x, y = promote(x, _t(y, x))
    if axis == 9:
        for i, s in enumerate(x.shape):
            if s == 3:
                axis = i
                break
        else:
            raise ValueError("cross: no axis of size 3 found")
    return torch.linalg.cross(x, y, dim=int(axis))


def histogram(input, bins=100, min=0, max=0, name=None):
    """int64 counts of `bins` equal bins over [min, max] (the data's own
    range when both are 0)."""
    x = _t(input).reshape(-1, 1)
    rng = None if (min == 0 and max == 0) else [(min, max)]
    hist, _ = histogramdd(x, bins=int(bins), ranges=rng)
    return hist.to(torch.int64)


def bincount(x, weights=None, minlength=0, name=None):
    x = _t(x)
    if weights is None:
        return torch.bincount(x, minlength=int(minlength)).to(torch.int64)
    w = _t(weights, x)
    return torch.bincount(x, weights=w, minlength=int(minlength)).to(
        w.dtype)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = _t(x)
    x = as_dtype(x, to_inexact(x.dtype))
    if not rowvar and x.dim() > 1:
        x = x.T
    fw = None if fweights is None else _t(fweights, x)
    aw = None if aweights is None else _t(aweights, x)
    return torch.cov(x, correction=1 if ddof else 0, fweights=fw,
                     aweights=aw)


def corrcoef(x, rowvar=True, name=None):
    x = _t(x)
    x = as_dtype(x, to_inexact(x.dtype))
    if not rowvar and x.dim() > 1:
        x = x.T
    return torch.corrcoef(x)


def cos_sim(X, Y):
    """sum(X * Y) / (|X| |Y|) over the last axis."""
    x = _t(X, Y)
    x, y = promote(x, _t(Y, x))
    xn = _sqrt(_isum(_square(x), -1))
    yn = _sqrt(_isum(_square(y), -1))
    return divide(_isum(x * y, -1), multiply(xn, yn))


__all__ = ["matmul", "mm", "bmm", "dot", "mv", "addmm", "einsum",
           "multi_dot", "matrix_power", "norm", "dist", "cross",
           "histogram", "bincount", "cov", "corrcoef", "cos_sim"]
