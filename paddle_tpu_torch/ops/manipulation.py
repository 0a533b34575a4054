"""Shape, index, sort and search ops (counterpart of
paddle_tpu/ops/manipulation.py).

Where torch's op of the same name orders ties or lays out arguments
otherwise, the reference's rule is kept, so that the card and the CPU
agree bitwise: sorts are stable; a descending sort and argsort flip a
stable ascending one (equal keys come out last index first); `topk`
puts the lower index first among ties (a stable descending sort);
`mode` is the smallest of the most frequent values at its first index;
`pad`'s pairs walk back from the innermost spatial dim.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from .common import _t, as_dtype, promote, result_type, scalar_value

_slice = builtins.slice


def _shape_arg(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(v) for v in shape.tolist())
    return tuple(int(scalar_value(s)) for s in shape)


def reshape(x, shape, name=None):
    return torch.reshape(_t(x), _shape_arg(shape))


def reshape_(x, shape, name=None):
    """In place: x's view takes `shape` (x.data rebinds to it)."""
    x.data = x.data.reshape(_shape_arg(shape))
    return x


def flatten(x, start_axis: int = 0, stop_axis: int = -1, name=None):
    """Dims start_axis..stop_axis (negative counts from the end) merged
    into one; a 0-d tensor becomes [1], as the reference's reshape to
    (-1,) makes it."""
    x = _t(x)
    nd = x.dim()
    sa = start_axis % nd if nd else 0
    ea = stop_axis % nd if nd else 0
    return x.reshape(*x.shape[:sa], -1, *x.shape[ea + 1:])


def squeeze(x, axis=None, name=None):
    """Size-1 dims removed: all of them, or those of `axis` that have
    size 1 (others are left, as the reference leaves them)."""
    x = _t(x)
    if axis is None:
        return torch.squeeze(x)
    axes = (axis,) if isinstance(axis, int) else tuple(int(a) for a in axis)
    axes = tuple(a for a in axes if x.shape[a] == 1)
    return torch.squeeze(x, axes) if axes else x


def unsqueeze(x, axis, name=None):
    """New size-1 dims at `axis` (an int, a list or a tensor), placed as
    numpy's expand_dims places them."""
    x = _t(x)
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    axes = (axis,) if isinstance(axis, int) else tuple(int(a) for a in axis)
    nd = x.dim() + len(axes)
    axes = sorted(a % nd for a in axes)
    shape = list(x.shape)
    for a in axes:
        shape.insert(a, 1)
    return x.reshape(shape)


def transpose(x, perm, name=None):
    return _t(x).permute(*(int(p) for p in perm))


def t(x, name=None):
    x = _t(x)
    return x if x.dim() < 2 else x.transpose(0, 1)


def moveaxis(x, source, destination, name=None):
    s = tuple(source) if isinstance(source, (list, tuple)) else (source,)
    d = tuple(destination) if isinstance(destination, (list, tuple)) \
        else (destination,)
    return torch.movedim(_t(x), s, d)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(_t(x), axis0, axis1)


def transpose_(x, perm, name=None):
    """In place: x.data rebinds to the permuted values."""
    x.data = x.data.permute(*(int(p) for p in perm)).contiguous()
    return x


def _promoted(xs):
    xs = [_t(v) for v in xs]
    dt = result_type(*xs)
    return [as_dtype(v, dt) for v in xs]


def concat(x, axis=0, name=None):
    return torch.cat(_promoted(x), int(scalar_value(axis)))


def stack(x, axis=0, name=None):
    return torch.stack(_promoted(x), int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """A list of pieces: `num_or_sections` equal ones, or pieces of the
    given sizes (one -1 takes the rest)."""
    x = _t(x)
    axis = int(scalar_value(axis))
    if isinstance(num_or_sections, (list, tuple)):
        sections = [int(scalar_value(s)) for s in num_or_sections]
        if -1 in sections:
            known = builtins.sum(s for s in sections if s != -1)
            sections = [x.shape[axis] - known if s == -1 else s
                        for s in sections]
        return list(torch.split(x, sections, axis))
    n = int(num_or_sections)
    if x.shape[axis] % n:
        raise ValueError(f"split: dim {axis} of size {x.shape[axis]} does "
                         f"not divide into {n} equal sections")
    return list(torch.split(x, x.shape[axis] // n, axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    return list(torch.unbind(_t(x), int(axis)))


unstack = unbind


def tile(x, repeat_times, name=None):
    x = _t(x)
    reps = _shape_arg(repeat_times)
    return torch.tile(x, reps)


def expand(x, shape, name=None):
    """x broadcast to `shape`; -1 keeps x's size there."""
    x = _t(x)
    shape = _shape_arg(shape)
    lead = len(shape) - x.dim()
    shape = tuple(x.shape[i - lead] if s == -1 and i >= lead else s
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


def expand_as(x, y, name=None):
    return expand(x, tuple(y.shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def broadcast_tensors(inputs, name=None):
    shape = torch.broadcast_shapes(*(tuple(t.shape) for t in inputs))
    return [expand(t, shape) for t in inputs]


def flip(x, axis, name=None):
    if isinstance(axis, int):
        axis = (axis,)
    return torch.flip(_t(x), tuple(int(a) for a in axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(_t(x), int(k), tuple(axes))


def roll(x, shifts, axis=None, name=None):
    x = _t(x)
    if axis is None:
        return torch.roll(x.reshape(-1), shifts).reshape(x.shape)
    return torch.roll(x, shifts, axis)


def _norm_index(index, n):
    """Negative indices counted from the end (JAX's gather and scatter
    normalize them)."""
    return torch.where(index < 0, index + n, index)


def gather(x, index, axis=0, name=None):
    x = _t(x)
    index = _t(index, x)
    axis = int(scalar_value(axis))
    if index.dim() == 0:
        index = index[None]
    idx = _norm_index(index, x.shape[axis]).reshape(-1)
    out = torch.index_select(x, axis, idx)
    return out.reshape(*x.shape[:axis % x.dim()], *index.shape,
                       *x.shape[axis % x.dim() + 1:])


def gather_nd(x, index, name=None):
    x = _t(x)
    index = _t(index, x)
    k = index.shape[-1]
    idx = tuple(_norm_index(index[..., i], x.shape[i]) for i in range(k))
    return x[idx]


def take_along_axis(arr, indices, axis, name=None):
    arr = _t(arr)
    indices = _t(indices, arr)
    shape = torch.broadcast_shapes(
        tuple(s for i, s in enumerate(arr.shape) if i != axis % arr.dim()),
        tuple(s for i, s in enumerate(indices.shape)
              if i != axis % arr.dim()))
    ax = axis % arr.dim()
    ishape = list(shape)
    ishape.insert(ax, indices.shape[ax])
    ashape = list(shape)
    ashape.insert(ax, arr.shape[ax])
    return torch.gather(arr.expand(ashape), ax,
                        _norm_index(indices, arr.shape[ax]).expand(ishape))


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """arr with `values` put at `indices` along `axis`: "assign", "add"
    or "mul"/"multiply"."""
    arr = _t(arr)
    indices = _norm_index(_t(indices, arr), arr.shape[axis])
    v = values if isinstance(values, torch.Tensor) else torch.tensor(
        values, device=arr.device)
    v = torch.broadcast_to(v.to(arr.dtype), indices.shape)
    if reduce == "assign":
        return torch.scatter(arr, axis, indices, v)
    if reduce == "add":
        return torch.scatter_add(arr, axis, indices, v)
    if reduce in ("mul", "multiply"):
        return torch.scatter_reduce(arr, axis, indices, v, "prod")
    raise ValueError(f"unsupported reduce {reduce}")


def index_select(x, index, axis=0, name=None):
    x = _t(x)
    index = _t(index, x)
    return torch.index_select(x, axis, _norm_index(index, x.shape[axis]))


def index_sample(x, index, name=None):
    return take_along_axis(x, index, 1)


def index_add(x, index, axis, value, name=None):
    x = _t(x)
    index = _norm_index(_t(index, x), x.shape[axis])
    return torch.index_add(x, axis, index, _t(value, x).to(x.dtype))


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of x at `index` set to `updates` (overwrite) or, without
    overwrite, zeroed and then summed over repeated indices."""
    x = _t(x)
    index = _t(index, x)
    updates = _t(updates, x).to(x.dtype)
    if index.dim() == 2:
        index = index[:, 0]
    index = _norm_index(index, x.shape[0])
    if overwrite:
        return torch.index_put(x, (index,), updates)
    zeroed = torch.index_put(x, (index,), torch.zeros_like(updates))
    return torch.index_put(zeroed, (index,), updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x = _t(x)
    index = _t(index, x)
    k = index.shape[-1]
    idx = tuple(_norm_index(index[..., i], x.shape[i]) for i in range(k))
    return torch.index_put(x, idx, _t(updates, x).to(x.dtype),
                           accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    updates = _t(updates)
    zeros = torch.zeros(_shape_arg(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


def where(condition, x=None, y=None, name=None):
    """x where condition, else y (promoted together); with neither x nor
    y, the indices of condition's nonzeros as a tuple."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    condition = _t(condition)
    x = _t(x, condition)
    y = _t(y, condition)
    x, y = promote(x, y)
    return torch.where(condition.to(torch.bool), x, y)


def masked_fill(x, mask, value, name=None):
    """x with `value` (cast to x's dtype) where mask holds."""
    x = _t(x)
    value = float(scalar_value(value))
    return torch.where(_t(mask, x).to(torch.bool),
                       as_dtype(value, x.dtype, x.device), x)


def nonzero(x, as_tuple=False):
    x = _t(x)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def masked_select(x, mask, name=None):
    x = _t(x)
    return x[torch.broadcast_to(_t(mask, x).to(torch.bool), x.shape)]


def sort(x, axis=-1, descending=False, name=None):
    out = torch.sort(_t(x), dim=axis, stable=True).values
    return torch.flip(out, (axis,)) if descending else out


def argsort(x, axis=-1, descending=False, name=None):
    """The stable ascending order, flipped when descending: equal keys
    then come last index first, as in the reference."""
    out = torch.sort(_t(x), dim=axis, stable=True).indices
    return torch.flip(out, (axis,)) if descending else out


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """The k largest (or smallest) along axis and their indices; among
    equal values the lower index comes first (lax.top_k's order), on
    the card too."""
    x = _t(x)
    k = int(scalar_value(k))
    s = torch.sort(x if largest else -x, dim=axis, descending=True,
                   stable=True)
    idx = s.indices.narrow(axis, 0, k)
    return torch.gather(x, axis, idx), idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    vals, idx = topk(x, k, axis=axis, largest=False)
    v = vals.narrow(axis, k - 1, 1)
    i = idx.narrow(axis, k - 1, 1)
    if not keepdim:
        v, i = v.squeeze(axis), i.squeeze(axis)
    return v, i


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along axis (the smallest among equally
    frequent ones) and the index of its first occurrence."""
    x = _t(x)
    axis = int(axis)
    xm = torch.movedim(x, axis, -1)
    sv = torch.sort(xm, dim=-1, stable=True).values
    # each sorted value's count: the width of its run (the reference
    # counts equal pairs; the run's bounds give the same counts without
    # the [n, n] comparison)
    keys = (sv.to(torch.uint8) if sv.dtype == torch.bool else sv).contiguous()
    counts = (torch.searchsorted(keys, keys, right=True)
              - torch.searchsorted(keys, keys))
    best = torch.argmax(counts, dim=-1, keepdim=True)
    vals = torch.gather(sv, -1, best)
    idx = torch.argmax((xm == vals).to(torch.int8), dim=-1, keepdim=True)
    vals = torch.movedim(vals, -1, axis)
    idx = torch.movedim(idx, -1, axis)
    if not keepdim:
        vals, idx = vals.squeeze(axis), idx.squeeze(axis)
    return vals, idx


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """The sorted unique values (of the flattened x, or slices along
    axis) and, as asked, the first index of each, the inverse and the
    counts."""
    x = _t(x)
    flat = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    if not (return_index or return_inverse or return_counts):
        return vals
    outs = [vals]
    if return_index:
        n = flat.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=x.device)
        first = torch.full((vals.shape[0 if axis is None else axis],), n,
                           dtype=torch.int64, device=x.device)
        outs.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        outs.append(inv.reshape(x.shape) if axis is None else inv)
    if return_counts:
        outs.append(counts)
    return tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Values with consecutive repeats dropped (of the flattened x, or
    slices along axis); the inverse and counts as asked."""
    x = _t(x)
    flat = x.reshape(-1) if axis is None else x
    vals, inv, counts = torch.unique_consecutive(
        flat, return_inverse=True, return_counts=True, dim=axis)
    out = [vals]
    if return_inverse:
        out.append(inv.reshape(-1))
    if return_counts:
        out.append(counts)
    return out[0] if len(out) == 1 else tuple(out)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """`pad` as (before, after) pairs: for every dim when it has 2 * ndim
    entries, else walking back from the innermost spatial dim (the last
    dim in channel-first layouts, the one before the last in
    channel-last ones). Modes: constant, reflect, replicate, circular."""
    x = _t(x)
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    nd = x.dim()
    widths = [(0, 0)] * nd
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        top = nd - 1 if data_format in ("NCHW", "NCL", "NCDHW") else nd - 2
        for i in range(len(pad) // 2):
            widths[top - i] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [p for w in reversed(widths) for p in w]
        return torch.nn.functional.pad(x, flat, value=float(value))
    out = x
    for d, (lo, hi) in enumerate(widths):
        if lo or hi:
            out = _pad_dim(out, d, lo, hi, mode)
    return out


def _pad_dim(x, d, lo, hi, mode):
    n = x.shape[d]
    if mode == "reflect":
        idx = list(range(lo, 0, -1)) + list(range(n)) + \
            list(range(n - 2, n - 2 - hi, -1))
    elif mode == "replicate":
        idx = [0] * lo + list(range(n)) + [n - 1] * hi
    elif mode == "circular":
        idx = [(i - lo) % n for i in range(n + lo + hi)]
    else:
        raise ValueError(f"unknown pad mode {mode!r}")
    return torch.index_select(x, d, torch.tensor(idx, device=x.device))


def slice(x, axes, starts, ends, name=None):
    x = _t(x)
    sl = [_slice(None)] * x.dim()
    for ax, s, e in zip(axes, starts, ends):
        sl[ax] = _slice(int(scalar_value(s)), int(scalar_value(e)))
    return x[tuple(sl)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """x[start:end:stride] along each axis; a negative stride walks back
    (numpy's slicing, which torch's lacks: taken by a flip)."""
    x = _t(x)
    for ax, s, e, st in zip(axes, starts, ends, strides):
        s, e, st = (int(scalar_value(v)) for v in (s, e, st))
        idx = np.arange(x.shape[ax])[_slice(s, e, st)].copy()
        x = torch.index_select(x, int(ax), torch.as_tensor(
            idx, dtype=torch.int64, device=x.device))
    return x


def getitem(x, idx):
    """x[idx] (a tensor's indexing as a function)."""
    return _t(x)[idx]


def one_hot(x, num_classes, name=None):
    """float32 rows with a 1 at each id (a row of zeros for an id out of
    range)."""
    x = _t(x)
    classes = torch.arange(int(num_classes), device=x.device)
    return (x[..., None] == classes).to(torch.float32)


def tensordot(x, y, axes=2, name=None):
    x = _t(x)
    x, y = promote(x, _t(y, x))
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = _t(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    if isinstance(repeats, torch.Tensor):
        return torch.repeat_interleave(x, repeats.to(x.device), dim=axis)
    return torch.repeat_interleave(x, int(repeats), dim=axis)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    seq = _t(sorted_sequence)
    values = _t(values, seq)
    seq, values = promote(seq, values)
    out = torch.searchsorted(seq.contiguous(), values.contiguous(),
                             right=bool(right))
    return out.to(torch.int32) if out_int32 else out


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32=out_int32, right=right)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    v = _t(input)
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.floor_divide(v, shard_size) == int(shard_id)
    return torch.where(in_shard, torch.remainder(v, shard_size),
                       as_dtype(int(ignore_value),
                                result_type(v, int(ignore_value)),
                                v.device))


def crop(x, shape=None, offsets=None, name=None):
    x = _t(x)
    shape = _shape_arg(shape)
    offsets = [0] * x.dim() if offsets is None else [
        int(scalar_value(o)) for o in offsets]
    ends = [o + (s if s != -1 else x.shape[i] - o)
            for i, (o, s) in enumerate(zip(offsets, shape))]
    return slice(x, list(range(x.dim())), offsets, ends)


def reverse(x, axis, name=None):
    return flip(x, axis)


def vsplit(x, num_or_sections, name=None):
    if _t(x).dim() < 2:
        raise ValueError("vsplit expects a tensor with at least 2 dimensions")
    return split(x, num_or_sections, axis=0)


def multiplex(inputs, index, name=None):
    """Row i of inputs[index[i]]."""
    stacked = torch.stack(_promoted(inputs))
    idx = _t(index, stacked).reshape(-1).to(torch.int64)
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return stacked[idx, rows]


# --------------------------------------------------- tensor arrays --------
def create_array(dtype="float32", initialized_list=None):
    """A tensor array: a plain Python list of tensors."""
    return list(initialized_list) if initialized_list is not None else []


def array_write(x, i, array=None):
    i = int(scalar_value(i))
    if array is None:
        array = []
    while len(array) <= i:
        array.append(None)
    array[i] = _t(x)
    return array


def array_read(array, i):
    return array[int(scalar_value(i))]


def array_length(array):
    return len(array)
