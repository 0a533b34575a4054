"""Shape ops (counterpart of paddle_tpu/ops/manipulation.py, cut to what
the ported models call)."""
from __future__ import annotations

import torch


def flatten(x: torch.Tensor, start_axis: int = 0, stop_axis: int = -1):
    """Dims start_axis..stop_axis (negative counts from the end) merged
    into one; a 0-d tensor becomes [1], as the reference's reshape to
    (-1,) makes it."""
    nd = x.dim()
    sa = start_axis % nd if nd else 0
    ea = stop_axis % nd if nd else 0
    return x.reshape(*x.shape[:sa], -1, *x.shape[ea + 1:])
