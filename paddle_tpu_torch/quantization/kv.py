"""The generation engine's KV pool and weight-only int8 helpers
(counterpart of paddle_tpu/quantization/kv.py).

Per worker the pool is a pair of buffers [rows, L, cap, H, Dh] whose
rows are decode slots, one scratch row and the prefix cache's rows.
With kv_dtype "f32" a buffer is a float32 tensor; with "int8" it is a
`QuantizedKV`: int8 data plus a float32 absmax scale per (row, layer).
The reference threads the buffers functionally through its programs;
here the helpers update the tensors in place and return the buffer, so
the call sites read as the reference's.

Scale scheme (per pool row and layer, symmetric, no zero point):

- `store_block` (prefill) resets the row's scale from the block's
  per-layer absmax (floored at 1e-6, so an all-zero warm-up block does
  not divide by zero), then quantizes the block;
- `scatter_rows` (decode, verify, extend) quantizes new positions with
  the row's existing scale: clip semantics, a late outlier saturates at
  +-127 and the row is never requantized;
- `fake_quant` is the round trip a scatter then a gather through the
  pool gives, bitwise, so a body attending positions it wrote this call
  reads what the next call will read back from the pool;
- `copy_row` and `set_row_raw` move raw int8 rows with their scales: a
  prefix-cache hit is exact, never a requantization.

Weight-only int8 (`quantize_stacked_params`) turns the stacked matmul
weights into `name__q` (int8) and `name__s` (float32 scales, per layer
for the stacked ones, per tensor for an untied lm_head) and drops the
float entry, so the weights at rest are int8. The program bodies take a
layer's weights through `weight(p, name, l)`, which dequantizes that one
layer (the reference dequantizes the stack inside its traced program,
where XLA fuses the multiply into the matmul; eager PyTorch would hold
the whole float stack at once). `dequant_params` rebuilds the whole
float dict, as the reference's does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import quantize_absmax

_QMAX = 127.0
# absmax floor before the /127: a zero block (warm-up, or a pathological
# prompt) quantizes against this instead of dividing by zero
_ABSMAX_FLOOR = 1e-6
# stacked matmul weights that weight-only int8 quantizes; embeddings,
# norms and biases stay float32
_QUANT_WEIGHT_KEYS = ("qkv_w", "out_w", "fc1_w", "fc2_w", "lm_head")


def _check_dtype(kv_dtype: str) -> None:
    if kv_dtype not in ("f32", "int8"):
        raise ValueError(
            f"kv_dtype must be 'f32' or 'int8' (got {kv_dtype!r})")


class QuantizedKV(NamedTuple):
    """One pool buffer in int8 with a float32 absmax scale per (row,
    layer)."""

    data: torch.Tensor    # int8 [rows, L, cap, H, Dh]
    scale: torch.Tensor   # f32 [rows, L]: absmax / 127

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())


def is_quantized(buf) -> bool:
    return isinstance(buf, QuantizedKV)


def cap_of(buf) -> int:
    """The positions a pool row holds."""
    return (buf.data if is_quantized(buf) else buf).shape[2]


def _bscale(s, x):
    """s with singleton dims appended so that it broadcasts over x's
    trailing axes (s indexes x's leading axes)."""
    return s.reshape(tuple(s.shape) + (1,) * (x.dim() - s.dim()))


def quant(x, s):
    """Symmetric int8 grid values of x under scale s (a float tensor;
    callers cast to int8 for storage). Round half to even, as jnp.round."""
    return torch.clamp(torch.round(x / _bscale(s, x)), -_QMAX, _QMAX)


def fake_quant(x, s):
    """Quantize-dequantize x with scale s; the identity when s is None
    (the float pool)."""
    if s is None:
        return x
    return quant(x, s) * _bscale(s, x)


def block_scale(ks):
    """Per-layer absmax scale [L] of a fresh [L, S, H, Dh] block."""
    a = torch.amax(torch.abs(ks), dim=(1, 2, 3))
    return torch.clamp(a, min=_ABSMAX_FLOOR) / _QMAX


def alloc(shape, device, kv_dtype: str = "f32"):
    """Zeroed pool buffer of `shape` on `device`: a float32 tensor for
    'f32', a QuantizedKV (int8 zeros, unit scales) for 'int8'."""
    _check_dtype(kv_dtype)
    shape = tuple(int(d) for d in shape)
    if kv_dtype == "f32":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return QuantizedKV(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.ones(shape[:2], dtype=torch.float32,
                                  device=device))


def pool_nbytes(shape, kv_dtype: str = "f32") -> int:
    """Bytes one pool buffer of `shape` allocates, as alloc() makes it
    (int8 data plus the float32 scale per (row, layer))."""
    _check_dtype(kv_dtype)
    n = int(np.prod(shape))
    if kv_dtype == "f32":
        return n * 4
    return n + int(shape[0]) * int(shape[1]) * 4


def store_block(buf, slot, ks):
    """Prefill's block store: ks [L, S, H, Dh] lands at positions [0, S)
    of pool row `slot` (S <= cap). An int8 pool resets the row's scales
    from this block's per-layer absmax, then quantizes it."""
    slot, S = int(slot), ks.shape[1]
    if not is_quantized(buf):
        buf[slot, :, :S] = ks.to(buf.dtype)
        return buf
    s = block_scale(ks)                                        # [L]
    buf.data[slot, :, :S] = quant(ks, s).to(torch.int8)
    buf.scale[slot] = s
    return buf


def gather_rows(buf, slots):
    """Pool rows for `slots` (a 1-D tensor or an int): (a float32 copy
    [..., L, M, H, Dh], the rows' scales [..., L] or None for the float
    pool). An int8 row dequantizes as data * scale; its scales come back
    so that a body can fake-quant the positions it writes with the scale
    the final scatter quantizes with."""
    if not (isinstance(slots, torch.Tensor) and slots.dim() > 0):
        slots = int(slots)
    if not is_quantized(buf):
        rows = buf[slots]
        return (rows if isinstance(slots, torch.Tensor) else rows.clone(),
                None)
    s = buf.scale[slots]
    return buf.data[slots].to(s.dtype) * s[..., None, None, None], s


def scatter_rows(buf, wslot, wpos, vals):
    """Write new positions: vals (wslot.shape + (L, H, Dh)) lands at
    buf[wslot[i], l, wpos[i]] for every index i and layer l. An int8 pool
    quantizes with each target row's existing scale."""
    L = vals.shape[wslot.dim()]
    data = buf.data if is_quantized(buf) else buf
    lix = torch.arange(L, device=data.device).reshape(
        (1,) * wslot.dim() + (L,))
    index = (wslot[..., None], lix, wpos[..., None])
    if not is_quantized(buf):
        buf.index_put_(index, vals.to(buf.dtype))
    else:
        buf.data.index_put_(index, quant(vals, buf.scale[wslot])
                            .to(torch.int8))
    return buf


def copy_row(buf, src, dst):
    """Copy pool row `src` into row `dst`: an int8 row raw, with its
    scales."""
    if not is_quantized(buf):
        buf[int(dst)] = buf[int(src)]
        return buf
    buf.data[int(dst)] = buf.data[int(src)]
    buf.scale[int(dst)] = buf.scale[int(src)]
    return buf


def row_raw(buf, slot):
    """One pool row in its stored dtype: (data [L, cap, H, Dh], scale [L]
    or None)."""
    if not is_quantized(buf):
        return buf[int(slot)], None
    return buf.data[int(slot)], buf.scale[int(slot)]


def set_row_raw(buf, slot, data, scale=None):
    """Install a row that `row_raw` gave: raw values (and, on an int8
    pool, its scales, which it needs) into pool row `slot`."""
    if not is_quantized(buf):
        buf[int(slot)] = data.to(buf.dtype)
        return buf
    buf.data[int(slot)] = data.to(buf.data.dtype)
    buf.scale[int(slot)] = scale.to(buf.scale.dtype)
    return buf


def quantize_stacked_params(params: dict) -> dict:
    """Weight-only int8 over a stacked parameter dict: each matmul weight
    becomes `name__q` (int8) and `name__s` (float32), with per-layer
    absmax scales ([L, 1, 1]) for the stacked weights and one per-tensor
    scale for an untied lm_head. Returns a new dict without the float
    matmul entries."""
    out = {}
    for k, v in params.items():
        if k not in _QUANT_WEIGHT_KEYS:
            out[k] = v
            continue
        dims = tuple(range(1, v.dim())) if k != "lm_head" else None
        q, s = quantize_absmax(v, dims)
        out[k + "__q"] = q
        out[k + "__s"] = torch.as_tensor(s, dtype=torch.float32,
                                         device=v.device)
    return out


def weight(p: dict, name: str, l=None):
    """Matmul weight `name` of layer `l` (or the whole tensor when l is
    None) in float32, dequantized from its int8 pair if `p` holds one."""
    q = p.get(name + "__q")
    if q is None:
        return p[name] if l is None else p[name][l]
    s = p[name + "__s"]
    if l is None:
        return q.to(s.dtype) * s
    return q[l].to(s.dtype) * s[l]


def dequant_params(p: dict) -> dict:
    """Float matmul weights from the `__q`/`__s` pairs (the identity on a
    float dict)."""
    if not any(k.endswith("__q") for k in p):
        return p
    out = {k: v for k, v in p.items() if not k.endswith(("__q", "__s"))}
    for k in p:
        if k.endswith("__q"):
            out[k[:-3]] = weight(p, k[:-3])
    return out


__all__ = ["QuantizedKV", "is_quantized", "cap_of", "alloc", "pool_nbytes",
           "quant", "fake_quant", "block_scale", "store_block",
           "gather_rows", "scatter_rows", "copy_row", "row_raw",
           "set_row_raw", "quantize_stacked_params", "weight",
           "dequant_params"]
