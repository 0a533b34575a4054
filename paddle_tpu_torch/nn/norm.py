"""Normalisation layers (counterpart of paddle_tpu/nn/norm.py)."""
from __future__ import annotations

import torch

from . import functional as F


class LayerNorm(torch.nn.LayerNorm):
    """torch's LayerNorm parameters (`weight`, `bias`) with the reference's
    arithmetic (`functional.layer_norm`)."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.eps)
