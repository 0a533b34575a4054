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


class _BatchNormBase(torch.nn.Module):
    """The reference's batch norm layer: `weight` (ones) and `bias`
    (zeros), None with weight_attr / bias_attr False, and the f32
    buffers `_mean` (zeros) and `_variance` (ones) under the reference's
    names, updated in training by `functional.batch_norm`."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, device=None, dtype=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.epsilon = epsilon
        self.data_format = data_format
        self.use_global_stats = use_global_stats
        factory = {"device": device, "dtype": dtype}
        self.weight = (None if weight_attr is False else torch.nn.Parameter(
            torch.ones(num_features, **factory)))
        self.bias = (None if bias_attr is False else torch.nn.Parameter(
            torch.zeros(num_features, **factory)))
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self.momentum, epsilon=self.epsilon,
                            data_format=self.data_format,
                            use_global_stats=self.use_global_stats)

    def extra_repr(self):
        return f"num_features={self.num_features}, momentum={self.momentum}"


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass
