"""Reductions (counterpart of paddle_tpu/ops/reduction.py), with the
reference's result dtypes: a sum or product of bool or of a narrower
integer is int64 (uint64 when unsigned), a mean, variance or median of
an integer is its inexact type (int32 to float32, int64 to float64), and
an even-count median averages the middle pair."""
from __future__ import annotations

import builtins

import torch

from ..core.dtype import convert_dtype
from .common import _t, as_dtype, to_inexact
from .math import _isum, _sum_dtype


def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis):
    """torch's `dim` for a reference axis: every dim for None."""
    axis = _axes(axis)
    if axis is None:
        return tuple(range(x.dim()))
    return axis


def sum(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    return _isum(x, _dims(x, axis), bool(keepdim))


def mean(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    x = as_dtype(x, to_inexact(x.dtype))
    return torch.mean(x, _dims(x, axis), keepdim=bool(keepdim))


def prod(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    dt = _sum_dtype(x.dtype)
    dims = _dims(x, axis)
    dims = (dims,) if isinstance(dims, int) else dims
    # torch's prod takes one dim at a time, and no uint64: an unsigned
    # product runs in int64 (the same bits) and is cast back
    out = as_dtype(x, torch.int64 if dt == torch.uint64 else dt)
    for d in sorted((d % builtins.max(x.dim(), 1) for d in dims),
                    reverse=True):
        out = torch.prod(out, d, keepdim=bool(keepdim))
    return out.to(dt)


def _extreme(fn):
    def op(x, axis=None, keepdim=False, name=None):
        x = _t(x)
        return fn(x, _dims(x, axis), keepdim=bool(keepdim))

    return op


amax = _extreme(torch.amax)
amin = _extreme(torch.amin)
max = amax
min = amin


def nansum(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    return _isum(x, _dims(x, axis), bool(keepdim), torch.nansum)


def nanmean(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    x = as_dtype(x, to_inexact(x.dtype))
    return torch.nanmean(x, _dims(x, axis), keepdim=bool(keepdim))


def _logical(fn):
    def op(x, axis=None, keepdim=False, name=None):
        x = _t(x)
        return fn(x.to(torch.bool), _dims(x, axis), keepdim=bool(keepdim))

    return op


all = _logical(torch.all)
any = _logical(torch.any)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _t(x)
    x = as_dtype(x, to_inexact(x.dtype))
    return torch.std(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=bool(keepdim))


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    x = _t(x)
    x = as_dtype(x, to_inexact(x.dtype))
    return torch.var(x, _dims(x, axis), correction=1 if unbiased else 0,
                     keepdim=bool(keepdim))


def _to_last(x, axis, keepdim):
    """x with the reduced axes merged into one last dim, and the shape a
    keepdim result takes (None without keepdim)."""
    axis = _axes(axis)
    nd = x.dim()
    if axis is None:
        return x.reshape(-1), ([1] * nd if keepdim else None)
    axes = (axis,) if isinstance(axis, int) else axis
    axes = sorted(a % nd for a in axes)
    keep = [d for d in range(nd) if d not in axes]
    moved = x.permute(*keep, *axes)
    out = moved.reshape(*[x.shape[d] for d in keep], -1)
    kshape = [1 if d in axes else x.shape[d] for d in range(nd)]
    return out, (kshape if keepdim else None)


def _quantile(x, q, axis, keepdim, method, squash_nans):
    """JAX's `_quantile` over the last dim after the reduced axes are
    merged there: a sorted copy (NaN last); "linear" interpolates in the
    dtype of q (float64 for a Python q), "midpoint" averages in x's; a
    NaN along the axis makes the result NaN unless `squash_nans`, which
    reads only the non-NaN values."""
    x = _t(x)
    x = as_dtype(x, to_inexact(x.dtype))
    a, kshape = _to_last(x, axis, keepdim)
    qt = torch.as_tensor(q, dtype=torch.float64, device=a.device) \
        if not isinstance(q, torch.Tensor) else q.to(a.device)
    q_nd = qt.dim()
    qv = qt.reshape(-1, *([1] * a.dim()))    # [nq, 1, ..., 1]
    if squash_nans:
        a = torch.where(torch.isnan(a), torch.nan, a)
        a = torch.sort(a, dim=-1).values
        counts = (~torch.isnan(a)).sum(-1, keepdim=True).to(qt.dtype)
        pos = qv * (counts - 1)
        hi_lim = counts - 1
    else:
        a = torch.where(torch.isnan(a).any(-1, keepdim=True), torch.nan, a)
        a = torch.sort(a, dim=-1).values
        n = torch.tensor(a.shape[-1], dtype=qt.dtype, device=a.device)
        pos = qv * (n - 1)
        hi_lim = n - 1
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    low = torch.maximum(torch.zeros_like(low), torch.minimum(low, hi_lim))
    high = torch.maximum(torch.zeros_like(high), torch.minimum(high, hi_lim))
    ab = a.expand(qv.shape[0], *a.shape)
    shape = ab.shape[:-1] + (1,)
    low_v = torch.gather(ab, -1, low.long().expand(shape)).squeeze(-1)
    high_v = torch.gather(ab, -1, high.long().expand(shape)).squeeze(-1)
    if method == "midpoint":
        out = (low_v + high_v) * 0.5
    else:
        lw = low_w.expand(shape).squeeze(-1)
        hw = high_w.expand(shape).squeeze(-1)
        out = (low_v.to(qt.dtype) * lw + high_v.to(qt.dtype) * hw
               ).to(a.dtype)
    if kshape is not None:
        out = out.reshape(out.shape[0], *kshape)
    if q_nd == 0:
        out = out[0]
    return out


def median(x, axis=None, keepdim=False, name=None):
    return _quantile(x, 0.5, axis, keepdim, "midpoint", False)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(x, 0.5, axis, keepdim, "midpoint", True)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(x, q, axis, keepdim, "linear", False)


def _arg(fn):
    def op(x, axis=None, keepdim=False, dtype="int64", name=None):
        x = _t(x)
        axis = _axes(axis)
        if axis is None:
            out = fn(x.reshape(-1), 0)
        else:
            out = fn(x, axis, keepdim=bool(keepdim))
        return out.to(convert_dtype(dtype))

    return op


argmax = _arg(torch.argmax)
argmin = _arg(torch.argmin)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = _t(x)
    dims = _dims(x, axis)
    return torch.sum(x != 0, dims, keepdim=bool(keepdim), dtype=torch.int64)


def numel(x, name=None):
    x = _t(x)
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)
