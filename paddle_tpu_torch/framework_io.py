"""Checkpoints in the reference's format, and its parameters in the port.

`save(obj, path)` and `load(path)` are `paddle_tpu.save`/`load`'s format
(paddle_tpu/framework_io.py): a pickle (protocol 4) of `obj` with every
tensor written as {"__tensor__": True, "data": ndarray, "stop_gradient",
"is_param", "name"}, through nested dicts, lists and tuples. A bfloat16
tensor is written as the reference writes it, an `ml_dtypes.bfloat16`
array of the same bits, without importing ml_dtypes: the pickle names
`ml_dtypes.bfloat16` as a global and the reader's numpy builds the
dtype from it. `load` reads such an array without ml_dtypes too, by its
raw 16-bit words viewed as torch.bfloat16; it admits numpy's array
reconstruction and that one global and nothing else, since unpickling
can run code. It returns every saved tensor as a CPU torch tensor.

`params_from_paddle_tpu` takes the JAX package's parameters (numpy
arrays or torch tensors), by the names its `named_parameters()` gives,
and returns a state_dict for the port's model of the same names: the
GPT (`GPTForCausalLM`), BERT (`BertForMaskedLM`) or a ResNet. Of the GPT
it accepts both the unrolled `GPTForCausalLM` names and the stacked
`GPTForCausalLMScan` names (`qkv_w [L, D, 3D]`, ...), which it unstacks;
of a ResNet also the batch-norm buffers `_mean` and `_variance` of its
`state_dict()`. Paddle stores a Linear weight as [in, out] and torch as
[out, in], so every Linear weight is transposed (the GPT's qkv, out, fc1
and fc2 projections and untied head; BERT's q, k, v and out projections,
linear1, linear2, pooler and transform; ResNet's fc); embeddings, conv
weights (one layout in both), norms and buffers pass as they are.
`params_to_paddle_tpu` is the way back (unrolled names), and
`transpose_optimizer_state` transposes an optimizer state_dict's
per-parameter entries (`p{i}.moment1`, ...) alike, either way, so that a
checkpoint of either package loads in the other. A name of none of these
models raises KeyError. For any other model (a `Sequential` of Linear
layers, say) `module_state_to_paddle_tpu` and
`module_state_from_paddle_tpu` find the Linear weights by module type
(`linear_weight_names`), which `transpose_optimizer_state(linear=...)`
takes too; hapi's Model.save and Model.load write and read the
reference's `.pdparams` and `.pdopt` through them.
"""
from __future__ import annotations

import os
import pickle
import re

import numpy as np
import torch

# the Linear layers whose weights are transposed: the GPT's, BERT's and
# ResNet's
_LINEARS = ("qkv_proj", "out_proj", "fc1", "fc2", "q_proj", "k_proj",
            "v_proj", "linear1", "linear2", "pooler", "transform", "fc")

# stacked scan-model name -> per-block unrolled name
_SCAN_BLOCK = {
    "ln1_w": "ln1.weight", "ln1_b": "ln1.bias",
    "qkv_w": "attn.qkv_proj.weight", "qkv_b": "attn.qkv_proj.bias",
    "out_w": "attn.out_proj.weight", "out_b": "attn.out_proj.bias",
    "ln2_w": "ln2.weight", "ln2_b": "ln2.bias",
    "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
    "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias",
}
_SCAN_TOP = {"wte.weight": "gpt.wte.weight", "wpe.weight": "gpt.wpe.weight",
             "ln_f.weight": "gpt.ln_f.weight", "ln_f.bias": "gpt.ln_f.bias",
             "lm_head_w": "lm_head.weight"}
_UNROLLED = re.compile(
    r"^(gpt\.(wte|wpe)\.weight|gpt\.ln_f\.(weight|bias)|lm_head\.weight|"
    r"gpt\.blocks\.\d+\.(ln1|ln2|attn\.qkv_proj|attn\.out_proj|mlp\.fc1|"
    r"mlp\.fc2)\.(weight|bias))$")
_BERT = re.compile(
    r"^(decoder_bias|(transform|layer_norm)\.(weight|bias)|"
    r"bert\.embeddings\.(word|position|token_type)_embeddings\.weight|"
    r"bert\.(embeddings\.layer_norm|pooler)\.(weight|bias)|"
    r"bert\.encoder\.layers\.\d+\.(self_attn\.(q|k|v|out)_proj|linear1|"
    r"linear2|norm1|norm2)\.(weight|bias))$")
_BN = r"\.(weight|bias|_mean|_variance)"
_RESNET = re.compile(
    r"^(conv1\.weight|bn1" + _BN + r"|fc\.(weight|bias)|layer[1-4]\.\d+\."
    r"(conv[1-3]\.weight|bn[1-3]" + _BN + r"|downsample\.0\.weight|"
    r"downsample\.1" + _BN + r"))$")


def _known(name: str) -> bool:
    """A name of the port's GPT (unrolled), BERT or ResNet."""
    return any(p.match(name) for p in (_UNROLLED, _BERT, _RESNET))


def _is_linear_weight(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] == "weight" and (parts[-2] in _LINEARS
                                      or name == "lm_head.weight")


def _unroll(named: dict) -> dict:
    """Scan-model names -> unrolled names (per-block slices of the stacks);
    unrolled names pass through. Unknown names raise."""
    out = {}
    for name, arr in named.items():
        if not isinstance(arr, torch.Tensor):
            arr = np.asarray(arr)
        if name in _SCAN_BLOCK:
            for i in range(arr.shape[0]):
                out[f"gpt.blocks.{i}.{_SCAN_BLOCK[name]}"] = arr[i]
        elif name in _SCAN_TOP:
            out[_SCAN_TOP[name]] = arr
        elif _known(name):
            out[name] = arr
        else:
            raise KeyError(f"params_from_paddle_tpu: unknown parameter "
                           f"{name!r}")
    return out


def _to_torch(arr) -> torch.Tensor:
    """A CPU tensor of `arr`; a bfloat16 numpy array (ml_dtypes, as the
    reference's arrays are) by its 16-bit words, without ml_dtypes."""
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().contiguous()
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_paddle_tpu(named: dict) -> dict:
    """{reference name: numpy array or tensor} -> state_dict of the port's
    model (CPU tensors of the arrays' dtypes; Linear weights
    transposed)."""
    sd = {}
    for name, arr in _unroll(named).items():
        if _is_linear_weight(name):
            arr = arr.T
        sd[name] = _to_torch(arr)
    return sd


def params_to_paddle_tpu(state_dict: dict) -> dict:
    """The port model's state_dict -> {reference (unrolled) name: CPU
    tensor in the reference's layout}: Linear weights transposed back."""
    out = {}
    for name, t in state_dict.items():
        if not _known(name):
            raise KeyError(f"params_to_paddle_tpu: unknown parameter "
                           f"{name!r}")
        t = t.detach().cpu()
        out[name] = (t.t() if _is_linear_weight(name) else t).contiguous()
    return out


def linear_weight_names(module: torch.nn.Module) -> set:
    """The state_dict names of the weights of `module`'s Linear layers
    (every torch.nn.Linear, whatever its name)."""
    return {f"{n}.weight" if n else "weight"
            for n, m in module.named_modules()
            if isinstance(m, torch.nn.Linear)}


def module_state_to_paddle_tpu(module: torch.nn.Module) -> dict:
    """`module.state_dict()` in the reference's layout, for any model:
    CPU tensors, the Linear weights transposed to [in, out]."""
    linear = linear_weight_names(module)
    return {n: (t.detach().cpu().t() if n in linear else
                t.detach().cpu()).contiguous()
            for n, t in module.state_dict().items()}


def module_state_from_paddle_tpu(module: torch.nn.Module, sd: dict) -> dict:
    """A reference-layout state_dict of `module`'s names as the port's
    state_dict of `module`: the Linear weights transposed to [out, in]."""
    linear = linear_weight_names(module)
    return {n: (_to_torch(v).t() if n in linear else
                _to_torch(v)).contiguous() for n, v in sd.items()}


def transpose_optimizer_state(opt_sd: dict, names, linear=None) -> dict:
    """An optimizer state_dict in the other package's layout, either way:
    the `p{i}.*` entries of every Linear weight transposed. `names[i]` is
    the name of the optimizer's i-th parameter (the model's
    `named_parameters()` order, which both packages share); `linear`
    (a set of names, linear_weight_names) says which are Linear weights,
    else the GPT's, BERT's and ResNet's names do."""
    names = list(names)
    is_linear = _is_linear_weight if linear is None else \
        (lambda n: n in linear)
    out = dict(opt_sd)
    for key, v in opt_sd.items():
        m = re.match(r"^p(\d+)\.", key) if isinstance(key, str) else None
        if m and is_linear(names[int(m.group(1))]):
            v = v if isinstance(v, torch.Tensor) else _to_torch(v)
            out[key] = v.t().contiguous()
    return out


# ------------------------------------------------------------ save/load --
class _Bf16Name:
    """Stands for the global `ml_dtypes.bfloat16` in a pickle."""


class _Bf16Dtype:
    """numpy's reduction of the bfloat16 dtype: np.dtype(bfloat16, False,
    True) with its state (byte order, itemsize 2, alignment 2, flags)."""

    def __reduce__(self):
        return (np.dtype, (_Bf16Name, False, True),
                (3, "<", None, None, None, 2, 2, 64))


class _Bf16Array:
    """numpy's reduction of a C-ordered bfloat16 array, from its uint16
    words."""

    def __init__(self, words: np.ndarray):
        self.words = words

    def __reduce__(self):
        return (_ndarray_reconstruct(), (np.ndarray, (0,), b"b"),
                (1, self.words.shape, _Bf16Dtype(), False,
                 self.words.tobytes()))


def _ndarray_reconstruct():
    try:
        from numpy._core.multiarray import _reconstruct
    except ImportError:                       # numpy 1
        from numpy.core.multiarray import _reconstruct
    return _reconstruct


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, which lets `save_global` write the
    global `ml_dtypes.bfloat16` without importing ml_dtypes."""

    def save_global(self, obj, name=None):
        if obj is _Bf16Name:
            self.save("ml_dtypes")
            self.save("bfloat16")
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _tensor_data(t: torch.Tensor):
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return _Bf16Array(t.view(torch.int16).numpy().view(np.uint16))
    return t.numpy()


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": True, "data": _tensor_data(obj),
                "stop_gradient": not obj.requires_grad,
                "is_param": isinstance(obj, torch.nn.Parameter),
                "name": None}
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


def save(obj, path, protocol=4):
    """paddle_tpu.save's format: see the module's docstring."""
    if protocol < 4:
        raise ValueError("save: bfloat16 arrays need pickle protocol >= 4")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_to_saveable(obj))


class _Bf16Marker:
    """What `load` reads for the dtype `ml_dtypes.bfloat16`."""

    def __setstate__(self, state):
        pass


def _load_dtype(obj, align=False, copy=False):
    if obj is _Bf16Marker:
        return _Bf16Marker()
    return np.dtype(obj, align, copy)


class _LoadedArray:
    """What `load` reads for an array: numpy's `_reconstruct` result, to
    which the pickle then hands (version, shape, dtype, fortran, bytes)."""

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if not isinstance(raw, (bytes, bytearray)):
            raise pickle.UnpicklingError("load: object arrays are not "
                                         "admitted")
        order = "F" if fortran else "C"
        if isinstance(dtype, _Bf16Marker):
            words = np.frombuffer(raw, np.int16).reshape(shape, order=order)
            self.value = torch.from_numpy(words.copy()).view(torch.bfloat16)
        else:
            self.value = np.frombuffer(raw, dtype).reshape(
                shape, order=order).copy()


def _load_reconstruct(cls, shape, typecode):
    return _LoadedArray()


def _load_frombuffer(buf, dtype, shape, order):
    """numpy's protocol-5 array reduction (`numeric._frombuffer`)."""
    a = _LoadedArray()
    a.__setstate__((1, shape, dtype, order == "F", bytes(buf)))
    return a.value


class _Unpickler(pickle.Unpickler):
    """Admits numpy's array reconstruction, numpy dtypes and
    `ml_dtypes.bfloat16`, and nothing else."""

    def find_class(self, module, name):
        if module in ("numpy", "numpy._core", "numpy.core"):
            if name == "ndarray":
                return np.ndarray
            if name == "dtype":
                return _load_dtype
        if module in ("numpy._core.multiarray", "numpy.core.multiarray") \
                and name == "_reconstruct":
            return _load_reconstruct
        if module in ("numpy._core.numeric", "numpy.core.numeric") \
                and name == "_frombuffer":
            return _load_frombuffer
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _Bf16Marker
        raise pickle.UnpicklingError(
            f"the checkpoint names {module}.{name}; only numpy arrays "
            f"(bfloat16 among them) are admitted")


def _from_loaded(obj):
    if isinstance(obj, _LoadedArray):
        return obj.value
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            data = _from_loaded(obj["data"])
            return data if isinstance(data, torch.Tensor) else \
                torch.from_numpy(np.asarray(data))
        return {k: _from_loaded(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_loaded(v) for v in obj)
    return obj


def load(path):
    """paddle_tpu.load's counterpart: every saved tensor comes back as a
    CPU torch tensor (bfloat16 ones as torch.bfloat16, same bits); a bare
    array outside a saved tensor as a numpy array (bfloat16: a tensor)."""
    with open(path, "rb") as f:
        return _from_loaded(_Unpickler(f).load())
