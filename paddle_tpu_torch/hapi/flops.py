"""Model FLOPs (counterpart of paddle_tpu/hapi/flops.py): a forward on
zeros of `input_size` with forward hooks on the counted layer types,
a multiply-accumulate counted as 2 FLOPs."""
from __future__ import annotations

import numpy as np
import torch

from .. import nn


def _conv_flops(layer, inp, out):
    k = layer.kernel_size
    groups = getattr(layer, "groups", 1) or 1
    out_elems = int(np.prod(out.shape))
    return 2 * out_elems * (layer.in_channels // groups) * int(np.prod(k))


def _linear_flops(layer, inp, out):
    return 2 * int(np.prod(out.shape)) * layer.in_features


def _norm_flops(layer, inp, out):
    return 2 * int(np.prod(inp.shape))


def _act_flops(layer, inp, out):
    return int(np.prod(inp.shape))


_DEFAULT_OPS = {
    nn.Conv2D: _conv_flops,
    nn.Linear: _linear_flops,
    nn.BatchNorm2D: _norm_flops,
    nn.LayerNorm: _norm_flops,
    nn.ReLU: _act_flops,
}


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Forward FLOPs of `net` on an input of `input_size`, on the device
    of its parameters."""
    table = dict(_DEFAULT_OPS)
    table.update(custom_ops or {})
    total = [0]
    rows = []
    hooks = []

    def make_hook(fn, layer):
        def hook(l, inputs, output):
            x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
            n = fn(layer, x, output)
            total[0] += n
            rows.append((type(layer).__name__, n))
        return hook

    for layer in net.modules():
        fn = table.get(type(layer))
        if fn is not None:
            hooks.append(layer.register_forward_hook(make_hook(fn, layer)))

    param = next(net.parameters(), None)
    x = torch.zeros(tuple(input_size), dtype=torch.float32,
                    device=None if param is None else param.device)
    was_training = net.training
    net.eval()
    try:
        with torch.no_grad():
            net(x)
    finally:
        net.train(was_training)
        for h in hooks:
            h.remove()
    if print_detail:
        for name, n in rows:
            print(f"  {name:<16} {n:,}")
        print(f"Total FLOPs: {total[0]:,}")
    return total[0]
