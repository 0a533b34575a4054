"""The generation engine's KV pool helpers (counterpart of
paddle_tpu/quantization/kv.py, its float-pool half).

Per capacity class the pool is a pair of float32 buffers
[rows, L, cap, H, Dh] whose rows are decode slots plus one scratch row.
The reference threads the buffers functionally through its programs
(`.at[].set`, `dynamic_update_slice`); here the helpers update the
buffer in place and return it, so the call sites read as the
reference's.

The int8 pool (`QuantizedKV`, quantize-on-scatter, per-row absmax
scales) and the weight-only int8 parameters are ROADMAP module queue
item 1d: `alloc(..., "int8")` and `pool_nbytes(..., "int8")` raise
NotImplementedError, and on a float pool `fake_quant` and
`dequant_params` are the identity.
"""
from __future__ import annotations

import numpy as np
import torch

_INT8_TODO = ("the int8 KV pool is not ported yet (ROADMAP module queue "
              "item 1d); use kv_dtype='f32'")


def _check_dtype(kv_dtype: str) -> None:
    if kv_dtype == "int8":
        raise NotImplementedError(_INT8_TODO)
    if kv_dtype != "f32":
        raise ValueError(f"kv_dtype must be 'f32' (got {kv_dtype!r})")


def is_quantized(buf) -> bool:
    """False: every pool of the port is a float tensor."""
    return False


def fake_quant(x, s):
    """The quantize-dequantize round trip of an int8 pool; the identity
    for the float pool (s is None)."""
    if s is not None:
        raise NotImplementedError(_INT8_TODO)
    return x


def dequant_params(p: dict) -> dict:
    """Float matmul weights from weight-only int8 pairs; the identity on
    a float parameter dict."""
    if any(k.endswith("__q") for k in p):
        raise NotImplementedError(
            "weight-only int8 parameters are not ported yet (ROADMAP "
            "module queue item 1d)")
    return p


def alloc(shape, device, kv_dtype: str = "f32") -> torch.Tensor:
    """Zeroed float32 pool buffer of `shape` on `device`."""
    _check_dtype(kv_dtype)
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


def pool_nbytes(shape, kv_dtype: str = "f32") -> int:
    """Bytes one pool buffer of `shape` allocates (as alloc())."""
    _check_dtype(kv_dtype)
    return int(np.prod(shape)) * 4


def store_block(buf, slot, ks):
    """Prefill's block store: ks [L, S, H, Dh] lands at positions [0, S)
    of pool row `slot` (S <= cap)."""
    buf[int(slot), :, :ks.shape[1]] = ks.to(buf.dtype)
    return buf


def gather_rows(buf, slots):
    """Pool rows for `slots` (a 1-D tensor or an int): (a copy [..., L, M,
    H, Dh], None); the None stands for the int8 pool's row scales."""
    if isinstance(slots, torch.Tensor) and slots.dim() > 0:
        return buf[slots], None
    return buf[int(slots)].clone(), None


def scatter_rows(buf, wslot, wpos, vals):
    """Write new positions: vals [b, L, H, Dh] lands at buf[wslot[i], l,
    wpos[i]] for every row i and layer l."""
    L = vals.shape[wslot.dim()]
    lix = torch.arange(L, device=buf.device).reshape(
        (1,) * wslot.dim() + (L,))
    buf.index_put_((wslot[..., None], lix, wpos[..., None]),
                   vals.to(buf.dtype))
    return buf


def copy_row(buf, src, dst):
    """Copy pool row `src` into row `dst`."""
    buf[int(dst)] = buf[int(src)]
    return buf


__all__ = ["is_quantized", "fake_quant", "dequant_params", "alloc",
           "pool_nbytes", "store_block", "gather_rows", "scatter_rows",
           "copy_row"]
