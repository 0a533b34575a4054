"""`to_tensor` (counterpart of paddle_tpu/core/tensor.py:417): a
torch.Tensor on `place` or on the current place, with the reference's
dtype rules. Paddle's Tensor class is not rebuilt: a tensor is a
torch.Tensor and `stop_gradient=False` is `requires_grad`."""
from __future__ import annotations

import numpy as np
import torch

from .dtype import convert_dtype
from .place import resolve_device


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, read by its 16-bit words
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_tensor(data, dtype=None, place=None,
              stop_gradient: bool = True) -> torch.Tensor:
    """A new tensor holding a copy of `data`. Python floats become
    float32, ints int64, bools bool; a list or tuple of floats float32;
    a numpy array keeps its dtype; a tensor keeps its dtype and, with no
    `place`, its device."""
    dtype = convert_dtype(dtype)
    if isinstance(data, torch.Tensor):
        device = data.device if place is None else resolve_device(place)
        out = data.detach().to(device=device, dtype=dtype, copy=True)
    else:
        device = resolve_device(place)
        if dtype is None and not isinstance(data, np.ndarray):
            if isinstance(data, bool):
                dtype = torch.bool
            elif isinstance(data, int):
                dtype = torch.int64
            elif isinstance(data, float):
                dtype = torch.float32
            elif isinstance(data, complex):
                dtype = torch.complex128
        a = np.array(data, copy=True)
        if dtype is None and isinstance(data, (list, tuple)) \
                and a.dtype == np.float64:
            dtype = torch.float32
        out = _from_numpy(a).to(device=device, dtype=dtype)
    if not stop_gradient and (out.is_floating_point() or out.is_complex()):
        out.requires_grad_(True)
    return out
