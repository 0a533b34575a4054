"""paddle_tpu_torch.quantization (counterpart of paddle_tpu/quantization,
cut to the absmax recipe that weight-only int8 serving uses; QAT, PTQ and
the quantized layers are not ported)."""
from __future__ import annotations

import torch


def absmax_scale(w, dims=None):
    """Symmetric int8 absmax scale: |w|.max() / 127 + 1e-12 in float32.
    dims=None is per tensor (computed in float64, as a Python float, as
    the reference's); a tuple of dims gives per-slice scales with kept
    dims."""
    a = w.detach().to(torch.float32).abs()
    if dims is None:
        return float(a.max()) / 127.0 + 1e-12
    return a.amax(dim=dims, keepdim=True) / 127.0 + 1e-12


def quantize_absmax(w, dims=None):
    """(int8 values, scale) of w under absmax_scale(w, dims): round half
    to even, clipped to [-127, 127]. A per-tensor scale divides in
    float32, as numpy divides an f32 array by a Python float."""
    scale = absmax_scale(w, dims)
    s = torch.tensor(scale, dtype=torch.float32) if dims is None else scale
    q = torch.clamp(torch.round(w.detach().to(torch.float32)
                                / s.to(w.device)), -127, 127)
    return q.to(torch.int8), scale


__all__ = ["absmax_scale", "quantize_absmax"]
