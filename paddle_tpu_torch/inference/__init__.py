"""paddle_tpu_torch.inference — the deployment path and serving
(counterpart of paddle_tpu/inference, the role of Paddle Inference's
AnalysisPredictor).

`save_inference_model(prefix, model, example_inputs)` exports the model's
eval forward with `torch.export`, on the device it will run on (the
card unless the model or the caller names the CPU), and writes:

  {prefix}.pdmodel    `torch.export.save` of the program, its weights
                      included: it loads without the model's code, in a
                      process that imports only this package (the
                      program calls this package's custom ops, which
                      `Predictor` registers before it loads)
  {prefix}.pdiparams  the pickled numpy state_dict (parameters by name,
                      buffers as `__buffer__.<name>`; bfloat16 arrays as
                      the reference writes them)
  {prefix}.meta.json  the reference's signature: input_names,
                      output_names, input_specs (None for a dynamic dim),
                      format_version 1; and `device`, the device type the
                      program was exported on

An InputSpec among the example inputs makes each None or -1 dimension a
`torch.export.Dim`, all of them in one export (jit.save passes its
input_spec so). `Predictor(Config(prefix))` loads the program once and
runs it many times; its device is the Config's, the card by default
(`enable_use_gpu(..., device_id)`, or the CPU with `disable_gpu()`). A
program runs only on the device type it was exported on: a Config that
names another raises, and nothing moves a Predictor to the CPU on its
own. `run` takes arrays (or handles filled beforehand) and returns
numpy arrays; a bfloat16 output comes back as float32 (numpy has no
bfloat16), which is exact. With tracing on, `execute` records its three
stages as spans: `predictor.h2d` (the inputs to the device),
`predictor.forward` (the program, until the device's stream has run it)
and `predictor.d2h` (the outputs to the host).

Serving: the dynamic-batching predict engine (`ServingEngine`), the
continuous-batching generation engine (`GenerativeEngine`) and their
HTTP front (`ServingHTTPServer`); see `serving`.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..observability import trace as _tr


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name as the metadata spells it."""
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _dtype_name(dt: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "int64", ...)."""
    return str(dt).replace("torch.", "")


class Config:
    """paddle.inference.Config analog: the model's path prefix and the
    device its Predictor runs on (the card unless `disable_gpu()`)."""

    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        self._prefix = None
        if model_path and model_path.endswith(".pdmodel"):
            self._prefix = model_path[:-len(".pdmodel")]
        elif model_path:
            self._prefix = model_path
        self._device: Optional[torch.device] = None     # the card

    def set_prog_file(self, path):
        self._prefix = path[:-len(".pdmodel")] if path.endswith(".pdmodel") \
            else path

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        # the pool size is PyTorch's caching allocator's to choose
        self._device = torch.device("cuda", int(device_id))

    def disable_gpu(self):
        self._device = torch.device("cpu")

    def enable_memory_optim(self):
        pass  # PyTorch's caching allocator owns the buffers

    def switch_ir_optim(self, x=True):
        pass  # the program runs as exported

    def device(self) -> torch.device:
        """The device the Predictor runs on: a named card, the current
        card for the default (raising without one), or the CPU."""
        dev = resolve_device(self._device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev


def config_for(prefix: str, device=None) -> Config:
    """A Config of `prefix` running on `device` (None: the card)."""
    cfg = Config(prefix)
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu":
            cfg.disable_gpu()
        elif device.type == "cuda":
            cfg.enable_use_gpu(0, device.index if device.index is not None
                               else torch.cuda.current_device())
        else:
            raise ValueError(f"no Predictor runs on {device}")
    return cfg


class _Handle:
    """Zero-copy-style tensor handle (ZeroCopyTensor analog)."""

    def __init__(self, name):
        self.name = name
        self._value = None

    def copy_from_cpu(self, arr):
        self._value = np.asarray(arr)

    def copy_to_cpu(self):
        return np.asarray(self._value)

    def reshape(self, shape):
        if self._value is not None:
            self._value = self._value.reshape(shape)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()           # exact; numpy has no bfloat16
    return t.cpu().numpy()


class Predictor:
    """AnalysisPredictor analog: load once, run many. The program is the
    exported module of `{prefix}.pdmodel`, on the Config's device."""

    def __init__(self, config: Config):
        # the program calls this package's custom ops (the flash forward):
        # they must be registered before it loads
        from ..ops import flash_attention  # noqa: F401

        prefix = config._prefix
        if not prefix:
            raise ValueError("Config names no model")
        with open(prefix + ".meta.json") as f:
            self._meta = json.load(f)
        device = config.device()
        saved = self._meta.get("device")
        if device.type != saved:
            raise ValueError(
                f"{prefix}.pdmodel was exported on {saved!r} and runs only "
                f"there; this Config runs on {device}. Export the model on "
                f"the device it is to run on")
        self._device = device
        with open(prefix + ".pdmodel", "rb") as f:
            self._exported = torch.export.load(f)
        self._module = self._exported.module().to(device)
        self._inputs = {n: _Handle(n) for n in self._meta["input_names"]}
        self._outputs = {n: _Handle(n) for n in self._meta["output_names"]}

    @property
    def device(self) -> torch.device:
        return self._device

    def get_input_names(self) -> List[str]:
        return list(self._inputs)

    def get_output_names(self) -> List[str]:
        return list(self._outputs)

    def get_input_handle(self, name) -> _Handle:
        return self._inputs[name]

    def get_output_handle(self, name) -> _Handle:
        return self._outputs[name]

    def execute(self, arrays) -> List[np.ndarray]:
        """Run the program on host arrays: each copied to the device, the
        outputs copied back as numpy arrays."""
        with _tr.span("predictor.h2d", "inference"):
            # torch.from_numpy needs a writable array: a read-only one (a
            # frombuffer view of a request's bytes) is copied first
            tens = [torch.from_numpy(np.require(a, requirements=("C", "W")))
                    .to(self._device) for a in arrays]
        with _tr.span("predictor.forward", "inference"):
            with torch.inference_mode():
                outs = self._module(*tens)
            if self._device.type == "cuda":
                # the copy below waits for the stream anyway; waiting here
                # puts the device's time in this span, not in the copy's
                torch.cuda.current_stream(self._device).synchronize()
        outs = list(outs) if isinstance(outs, (tuple, list)) else [outs]
        with _tr.span("predictor.d2h", "inference") as sp:
            host = [_to_numpy(o) for o in outs]
            sp.set(bytes=sum(o.nbytes for o in host))
        return host

    def run(self, inputs: Optional[Sequence] = None):
        """Execute; positional `inputs` (arrays) or pre-filled handles."""
        if inputs is None:
            inputs = [self._inputs[n]._value for n in self._inputs]
        outs = self.execute([np.asarray(a) for a in inputs])
        for n, o in zip(self._outputs, outs):
            self._outputs[n]._value = o
        return outs


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


def _model_device(model, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    for t in (*model.parameters(), *model.buffers()):
        return t.device
    return resolve_device(None)


def _example(a, device, n_dyn: int):
    """(example tensor, {axis: Dim} or None, spec) of one example input:
    an InputSpec's dynamic dims become Dims named d<n_dyn>, d<n_dyn+1>,
    ..., their example sizes 2, 3, ... (sizes 0 and 1 would be
    specialised)."""
    from ..jit import InputSpec

    if isinstance(a, InputSpec):
        dims, axes = [], {}
        for ax, d in enumerate(a.shape):
            if d is None or (isinstance(d, int) and d < 0):
                i = n_dyn + len(axes)
                axes[ax] = torch.export.Dim(f"d{i}")
                dims.append(2 + i)
            else:
                dims.append(int(d))
        t = torch.zeros(dims, dtype=_torch_dtype(a.dtype), device=device)
        shape = [None if ax in axes else d for ax, d in enumerate(dims)]
        return t, (axes or None), {"shape": shape,
                                   "dtype": _dtype_name(t.dtype)}
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    t = t.to(device)
    return t, None, {"shape": [int(d) for d in t.shape],
                     "dtype": _dtype_name(t.dtype)}


def save_inference_model(path_prefix: str, model, example_inputs,
                         input_names=None, output_names=None, device=None):
    """Export `model` for deployment (reference save_inference_model): its
    eval forward traced by torch.export on `device` (default: where the
    model's parameters are; the card for a model without any), with the
    weights in the program, plus the pickled parameters and the signature
    metadata (see the module's docstring). `example_inputs` are arrays or
    tensors (static shapes) or jit.InputSpec (None or -1: a dynamic
    dim). Output names default to "out", or "out0", "out1", ... for a
    model of several outputs."""
    from ..distributed.checkpoint import atomic_write_json
    from ..framework_io import _Pickler, _tensor_data
    from ..ops.flash_attention import resolve_dot_impl

    os.makedirs(os.path.dirname(os.path.abspath(path_prefix)), exist_ok=True)
    dev = _model_device(model, device)
    if dev.type == "cuda":
        # "auto" probes the card on real tensors now; under the trace the
        # attention reads the verdict kept for the card
        resolve_dot_impl(dev)
    examples, dynamic, specs = [], [], []
    for a in example_inputs:
        n_dyn = sum(len(d) for d in dynamic if d)
        t, axes, spec = _example(a, dev, n_dyn)
        examples.append(t)
        dynamic.append(axes)
        specs.append(spec)
    training = model.training
    model.eval()
    try:
        exported = torch.export.export(
            model, tuple(examples),
            dynamic_shapes=tuple(dynamic) if any(dynamic) else None)
    finally:
        model.train(training)
    with open(path_prefix + ".pdmodel", "wb") as f:
        torch.export.save(exported, f)

    state = {n: _tensor_data(p) for n, p in model.named_parameters()}
    state.update({f"__buffer__.{n}": _tensor_data(b)
                  for n, b in model.named_buffers()})
    with open(path_prefix + ".pdiparams", "wb") as f:
        _Pickler(f, protocol=4).dump(state)

    n_out = len(exported.graph_signature.user_outputs)
    meta = {
        "input_names": list(input_names) if input_names else
            [f"x{i}" for i in range(len(examples))],
        "output_names": list(output_names) if output_names else
            (["out"] if n_out == 1 else [f"out{i}" for i in range(n_out)]),
        "input_specs": specs,
        "format_version": 1,
        "device": dev.type,
    }
    atomic_write_json(path_prefix + ".meta.json", meta, indent=1)
    return path_prefix


def load_inference_model(path_prefix: str, device=None):
    """Returns (predictor, input_names, output_names) — the reference
    returns (program, feed_names, fetch_targets). `device`: where the
    Predictor runs (None: the card)."""
    pred = Predictor(config_for(path_prefix, device))
    return pred, pred.get_input_names(), pred.get_output_names()


from .serving import (GenerateHandle, GenerativeEngine,  # noqa: E402,F401
                      GenerativeMetrics, ServingEngine, ServingError,
                      ServingHTTPServer, stack_gpt_params)

__all__ = ["Config", "Predictor", "create_predictor", "config_for",
           "save_inference_model", "load_inference_model", "ServingEngine",
           "GenerativeEngine", "GenerateHandle", "GenerativeMetrics",
           "ServingError", "ServingHTTPServer", "stack_gpt_params"]
