"""Common layers (counterpart of paddle_tpu/nn/layers_common.py): Linear
through the port's `functional.linear` (so that auto_cast O1 casts it as
the reference's `linear` op); Embedding ([num, dim] weight, XavierNormal
as the reference initialises it, the padding row zero); the dropout
layers, which draw their masks from the default generator in training
mode and pass their input through in eval mode; Flatten, Identity and
the activations ReLU, Tanh and GELU."""
from __future__ import annotations

import math

import torch

from ..ops.manipulation import flatten
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


class Embedding(torch.nn.Module):
    """Rows of `weight` [num_embeddings, embedding_dim] at the ids; with
    `padding_idx`, that row starts at zero and the output at its ids is
    zero (`functional.embedding`)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, device=None,
                 dtype=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.padding_idx = padding_idx
        self.weight = torch.nn.Parameter(torch.empty(
            num_embeddings, embedding_dim, device=device, dtype=dtype))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """XavierNormal (std sqrt(2 / (num + dim))), the padding row zero."""
        std = math.sqrt(2.0 / (self.num_embeddings + self.embedding_dim))
        self.weight.normal_(0.0, std, generator=generator)
        if self.padding_idx is not None:
            self.weight[self.padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx)

    def extra_repr(self):
        return f"{self.num_embeddings}, {self.embedding_dim}"


class Flatten(torch.nn.Module):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return flatten(x, self.start_axis, self.stop_axis)


class Identity(torch.nn.Module):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class ReLU(torch.nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class Tanh(torch.nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.tanh(x)


class GELU(torch.nn.Module):
    def __init__(self, approximate=False, name=None):
        super().__init__()
        self.approximate = approximate

    def forward(self, x):
        return F.gelu(x, approximate=self.approximate)
