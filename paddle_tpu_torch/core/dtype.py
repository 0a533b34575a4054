"""Data types (counterpart of paddle_tpu/core/dtype.py): the reference's
dtype names as torch dtypes, and `convert_dtype`, which takes a name, a
numpy dtype (or type) or a torch dtype."""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_STR2DTYPE = {
    "bool": bool_,
    "uint8": uint8,
    "int8": int8,
    "int16": int16,
    "int32": int32,
    "int64": int64,
    "float16": float16,
    "bfloat16": bfloat16,
    "float32": float32,
    "float64": float64,
    "complex64": complex64,
    "complex128": complex128,
}
_DTYPE2STR = {v: k for k, v in _STR2DTYPE.items()}


def convert_dtype(dtype):
    """A name ("float32"), a numpy dtype or scalar type (np.float32,
    np.dtype("int64"), float) or a torch dtype, as a torch dtype; None
    stays None."""
    if dtype is None:
        return None
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR2DTYPE:
            raise ValueError(f"unknown dtype string: {dtype!r}")
        return _STR2DTYPE[dtype]
    # numpy names its bfloat16 (ml_dtypes') "bfloat16", so no import of
    # ml_dtypes is needed to read it
    name = np.dtype(dtype).name
    if name not in _STR2DTYPE:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return _STR2DTYPE[name]


def dtype_to_str(dtype) -> str:
    return _DTYPE2STR[convert_dtype(dtype)]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_complex(dtype) -> bool:
    return convert_dtype(dtype).is_complex


def is_integer(dtype) -> bool:
    d = convert_dtype(dtype)
    return not (d.is_floating_point or d.is_complex or d == torch.bool)
