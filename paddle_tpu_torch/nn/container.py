"""Containers (counterpart of paddle_tpu/nn/container.py): Sequential and
LayerList, their children keyed "0", "1", ... as in the reference, so
that state_dict keys match it."""
from __future__ import annotations

from collections import OrderedDict

import torch


class Sequential(torch.nn.Sequential):
    """Layers run in order. Built from layers, from (name, layer) pairs,
    or from one OrderedDict of them."""

    def __init__(self, *layers):
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            super().__init__(layers[0])
        elif any(isinstance(l, tuple) for l in layers):
            super().__init__(OrderedDict(
                l if isinstance(l, tuple) else (str(i), l)
                for i, l in enumerate(layers)))
        else:
            super().__init__(*layers)


class LayerList(torch.nn.ModuleList):
    """A list of layers (torch's ModuleList, whose keys are the
    reference's)."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
