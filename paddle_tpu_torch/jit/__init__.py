"""paddle_tpu_torch.jit (counterpart of paddle_tpu.jit, cut to the train
and eval steps and the deployment export).

`save(layer, path, input_spec=None)` always writes `{path}.pdparams`
(the state_dict through framework_io.save); with `input_spec` it also
writes the deployment artifact through inference.save_inference_model,
every None or -1 dimension a `torch.export.Dim` of one export (so a model
may have several dynamic axes). `load(path)` returns a TranslatedLayer
over a Predictor when `{path}.pdmodel` exists, else the state_dict.
`to_static` and dy2static are not ported (ROADMAP queue 4).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .train_step import EvalStep, TrainStep  # noqa: F401

__all__ = ["save", "load", "TrainStep", "EvalStep", "InputSpec",
           "TranslatedLayer"]


class InputSpec:
    """paddle.static.InputSpec analog: a shape (None or -1 for a dynamic
    dim) and a numpy dtype name."""

    def __init__(self, shape, dtype="float32", name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save analog: `{path}.pdparams` always; with `input_spec`
    the exported program, its parameters and its signature as well.
    `configs["device"]`: the device to export on (default: where the
    layer's parameters are)."""
    from ..framework_io import save as save_state

    save_state(layer.state_dict(), path + ".pdparams")
    if input_spec:
        from ..inference import save_inference_model

        save_inference_model(path, layer, list(input_spec),
                             device=configs.get("device"))


def load(path, **configs):
    """paddle.jit.load analog: with a `.pdmodel` present, a
    TranslatedLayer running the exported program on `configs["device"]`
    (default: the card); otherwise the saved state_dict."""
    from ..framework_io import load as load_state

    if os.path.exists(path + ".pdmodel"):
        from ..inference import Predictor, config_for

        return TranslatedLayer(Predictor(config_for(path,
                                                    configs.get("device"))))
    return load_state(path + ".pdparams")


class TranslatedLayer:
    """Callable deployment module over an exported program (reference
    paddle/jit TranslatedLayer; built by jit.load): tensors or arrays in,
    CPU tensors out."""

    def __init__(self, predictor):
        self._predictor = predictor

    def __call__(self, *args):
        vals = [a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a) for a in args]
        outs = [torch.from_numpy(o) for o in self._predictor.run(vals)]
        return outs[0] if len(outs) == 1 else outs

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("a deployment-exported module is inference-only")
