"""Special functions, nan-aware reductions, products and data-dependent
ops (counterpart of paddle_tpu/ops/extras.py). Its names that
ops/math.py and ops/reduction.py also define (nansum with a dtype,
kron and outer over tensor operands) are the ones the package exports,
as in the reference."""
from __future__ import annotations

import itertools

import torch

from ..core.dtype import convert_dtype
from .common import _t, as_dtype, promote, result_type, to_inexact
from .creation import _linspace
from .math import _binary, _isum, _unary, add, divide, multiply
from .math import pow as _pow
# re-exported: the reference's extras defines them again
from .math import (copysign, digamma, erfinv, gcd, hypot, i0,  # noqa: F401
                   i1, lcm, ldexp, lgamma, logaddexp, nextafter)
from .reduction import _dims, _quantile, nanmean  # noqa: F401

i0e = _unary(torch.special.i0e)
i1e = _unary(torch.special.i1e)


def polygamma(x, n, name=None):
    """The n-th derivative of digamma at x (n a weak operand of the
    promotion, as the reference passes it)."""
    x = _t(x)
    dt = to_inexact(result_type(int(n), x))
    return torch.polygamma(int(n), as_dtype(x, dt))


def igamma(x, a, name=None):
    """The regularized upper incomplete gamma Q(x, a) (x the shape, as
    the reference's argument order gives it)."""
    x = _t(x, a)
    x, a = promote(x, _t(a, x), inexact=True)
    return torch.special.gammaincc(x, a)


def igammac(x, a, name=None):
    """The regularized lower incomplete gamma P(x, a)."""
    x = _t(x, a)
    x, a = promote(x, _t(a, x), inexact=True)
    return torch.special.gammainc(x, a)


def frexp(x, name=None):
    """Mantissa and exponent; the exponent in x's dtype."""
    x = _t(x)
    m, e = torch.frexp(as_dtype(x, to_inexact(x.dtype)))
    return m, e.to(x.dtype)


def nansum(x, axis=None, dtype=None, keepdim=False, name=None):
    x = _t(x)
    out = _isum(x, _dims(x, axis), bool(keepdim), torch.nansum)
    return out if dtype is None else out.to(convert_dtype(dtype))


def logcumsumexp(x, axis=None, dtype=None, name=None):
    x = _t(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    return torch.logcumsumexp(x, int(axis))


def kron(x, y, name=None):
    x = _t(x, y)
    return torch.kron(*promote(x, _t(y, x)))


def outer(x, y, name=None):
    x = _t(x, y)
    a, b = promote(x, _t(y, x))
    return torch.outer(a.reshape(-1), b.reshape(-1))


def vander(x, n=None, increasing=False, name=None):
    """Columns x**(n-1), ..., x**0 (or ascending), each a power of x's
    dtype."""
    x = _t(x)
    n = x.shape[-1] if n is None else int(n)
    p = torch.arange(n, device=x.device).to(x.dtype)
    if not increasing:
        p = (n - 1) - p
    return torch.pow(x[..., None], p)


def take(x, index, mode="raise", name=None):
    """Elements of the flattened x at `index`: "raise" checks the range
    ([-n, n)) and then, as the reference, clamps into [0, n - 1]; "clip"
    clamps; "wrap" takes indices modulo n."""
    x = _t(x)
    index = _t(index, x)
    flat = x.reshape(-1)
    n = flat.numel()
    if mode == "raise" and index.numel() and (
            int(index.min()) < -n or int(index.max()) >= n):
        raise IndexError(f"take: index out of range for input with {n} "
                         f"elements")
    if mode == "wrap":
        idx = torch.remainder(index, n)
    else:
        idx = torch.clamp(index, 0, n - 1)
    return flat[idx]


def renorm(x, p, axis, max_norm, name=None):
    """Each slice along `axis` scaled to norm max_norm where its p-norm
    exceeds it (by max_norm / (norm + 1e-7))."""
    x = _t(x)
    axis = int(axis) % x.dim()
    others = tuple(i for i in range(x.dim()) if i != axis)
    s = _pow(torch.abs(x), float(p))
    if others:
        s = torch.sum(s, others, keepdim=True)
    norms = _pow(s, 1.0 / float(p))
    factor = torch.where(norms > float(max_norm),
                         divide(float(max_norm), add(norms, 1e-7)),
                         as_dtype(1.0, norms.dtype, norms.device))
    return multiply(x, factor)


def histogramdd(x, bins=10, ranges=None, density=False, weights=None,
                name=None):
    """jnp.histogramdd of samples x [N, D]: per dim, edges over `ranges`
    (or the data's min and max, widened by 0.5 when equal), samples
    binned by the right edge with the last edge in the last bin."""
    x = _t(x)
    w = None if weights is None else _t(weights, x)
    if w is None:
        x = as_dtype(x, to_inexact(x.dtype))
    else:
        x, w = promote(x, w, inexact=True)
    n, d = x.shape
    bins_per_dim = list(bins) if isinstance(bins, (list, tuple)) \
        else [bins] * d
    idx_by_dim, edges_by_dim = [], []
    for i in range(d):
        col = x[:, i]
        edges = _bin_edges(col, bins_per_dim[i],
                           None if ranges is None else ranges[i])
        idx = torch.searchsorted(edges, col.contiguous(), right=True)
        idx = torch.where(col == edges[-1], idx - 1, idx)
        idx_by_dim.append(idx)
        edges_by_dim.append(edges)
    nbins = [e.numel() + 1 for e in edges_by_dim]
    flat = torch.zeros((), dtype=torch.int64, device=x.device)
    for idx, nb in zip(idx_by_dim, nbins):
        flat = flat * nb + torch.clamp(idx, 0, nb - 1)
    total = 1
    for nb in nbins:
        total *= nb
    hist = torch.zeros(total, dtype=x.dtype if w is not None
                       else torch.int64, device=x.device)
    hist = hist.index_add(0, flat, w if w is not None
                          else torch.ones_like(flat))
    hist = hist.reshape(nbins)[tuple(slice(1, -1) for _ in range(d))]
    if density:
        hist = hist.to(x.dtype)
        hist = hist / hist.sum()
        for i, e in enumerate(edges_by_dim):
            shape = [1] * d
            shape[i] = -1
            hist = hist / torch.diff(e).reshape(shape)
    return hist, edges_by_dim


def _bin_edges(col, bins, rng):
    """jnp.histogram_bin_edges: linspace over (min, max) of rng or of the
    data, each end moved by 0.5 when they are equal."""
    if isinstance(bins, torch.Tensor) or isinstance(bins, (list, tuple)):
        return torch.as_tensor(bins, dtype=col.dtype, device=col.device)
    if rng is None:
        lo, hi = col.min(), col.max()
    else:
        lo = torch.tensor(rng[0], dtype=col.dtype, device=col.device)
        hi = torch.tensor(rng[1], dtype=col.dtype, device=col.device)
    same = hi - lo == 0
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    return _linspace(lo, hi, int(bins) + 1, col.dtype, col.device)


signbit = _unary(torch.signbit, "same")
sinc = _unary(torch.sinc)
xlogy = _binary(torch.xlogy, "inexact")


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = _t(x)
    pre = None if prepend is None else _t(prepend, x)
    app = None if append is None else _t(append, x)
    out = torch.diff(x, n=1, dim=int(axis), prepend=pre, append=app)
    for _ in range(int(n) - 1):
        out = torch.diff(out, dim=int(axis))
    return out


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    """0.5 * sum(dx * (y[1:] + y[:-1])) along axis (jnp.trapezoid)."""
    y = _t(y)
    if x is None:
        y = as_dtype(y, to_inexact(y.dtype))
        d = as_dtype(1.0 if dx is None else float(dx), y.dtype, y.device)
    else:
        y, xv = promote(y, _t(x, y), inexact=True)
        d = torch.diff(xv) if xv.dim() == 1 else torch.movedim(
            torch.diff(xv, dim=axis), axis, -1)
    y = torch.movedim(y, axis, -1)
    return 0.5 * (d * (y[..., 1:] + y[..., :-1])).sum(-1)


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = torch.movedim(_t(y), axis, -1)
    if x is not None:
        xv = _t(x, y)
        if xv.dim() == y.dim():
            xv = torch.movedim(xv, axis, -1)
        d = torch.diff(torch.broadcast_to(xv, y.shape), dim=-1)
    else:
        d = 1.0 if dx is None else float(dx)
    avg = divide(y[..., 1:] + y[..., :-1], 2.0)
    out = torch.cumsum(multiply(avg, d), -1)
    return torch.movedim(out, -1, axis)


def interp(x, xp, fp, left=None, right=None, name=None):
    """jnp.interp: fp at the right neighbour's index found by searchsorted
    (clipped to [1, n - 1]), linear between it and the one before; left
    and right (fp's ends by default) outside xp."""
    x = _t(x)
    xp = _t(xp, x)
    fp = _t(fp, x)
    x, xp = promote(x, xp, inexact=True)
    fp = as_dtype(fp, to_inexact(fp.dtype))
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True), 1, xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # numpy's spacing of the dtype's eps (a power of two): eps squared
    dx0 = torch.abs(dx) <= torch.finfo(xp.dtype).eps ** 2
    one = as_dtype(1, dx.dtype, dx.device)
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, one, dx)) * df)
    lv = fp[0] if left is None else as_dtype(left, f.dtype, f.device)
    rv = fp[-1] if right is None else as_dtype(right, f.dtype, f.device)
    f = torch.where(x < xp[0], lv, f)
    return torch.where(x > xp[-1], rv, f)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(x, q, axis, bool(keepdim), "linear", True)


def cartesian_prod(x, name=None):
    xs = [_t(v) for v in x]
    grids = torch.meshgrid(*xs, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def combinations(x, r=2, with_replacement=False, name=None):
    x = _t(x)
    comb = itertools.combinations_with_replacement if with_replacement \
        else itertools.combinations
    idx = list(comb(range(x.shape[0]), int(r)))
    if not idx:
        return torch.zeros((0, int(r)), dtype=x.dtype, device=x.device)
    return x[torch.tensor(idx, device=x.device)]


__all__ = [
    "lgamma", "digamma", "erfinv", "i0", "i0e", "i1", "i1e", "logaddexp",
    "copysign", "nextafter", "hypot", "gcd", "lcm", "ldexp", "polygamma",
    "igamma", "igammac", "frexp", "nansum", "nanmean", "logcumsumexp",
    "kron", "outer", "vander", "take", "renorm",
    "histogramdd", "signbit", "sinc", "xlogy", "diff", "trapezoid",
    "cumulative_trapezoid", "interp", "nanquantile", "cartesian_prod",
    "combinations",
]
