"""Common layers (counterpart of paddle_tpu/nn/layers_common.py): Linear
through the port's `functional.linear` (so that auto_cast O1 casts it as
the reference's `linear` op), and the dropout layers, which draw their
masks from the default generator in training mode and pass their input
through in eval mode."""
from __future__ import annotations

import torch

from . import functional as F


class Linear(torch.nn.Linear):
    """torch's Linear ([out, in] weight) through `functional.linear`."""

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Dropout(torch.nn.Module):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, p=self.p, axis=self.axis, training=self.training,
                         mode=self.mode)

    def extra_repr(self):
        return f"p={self.p}"


class Dropout2D(torch.nn.Module):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, p=self.p, training=self.training,
                           data_format=self.data_format)


class AlphaDropout(torch.nn.Module):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.alpha_dropout(x, p=self.p, training=self.training)
