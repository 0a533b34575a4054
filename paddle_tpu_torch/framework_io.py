"""Load the reference package's parameters into the port.

`params_from_paddle_tpu` takes the JAX package's parameters as numpy
arrays, by the names its `named_parameters()` gives, and returns a
state_dict for `paddle_tpu_torch.models.GPTForCausalLM`. It accepts both
the unrolled `GPTForCausalLM` names and the stacked
`GPTForCausalLMScan` names (`qkv_w [L, D, 3D]`, ...), which it unstacks.
Paddle stores a Linear weight as [in, out] and torch as [out, in], so
every Linear weight is transposed.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_LINEARS = ("qkv_proj", "out_proj", "fc1", "fc2")

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


def _is_linear_weight(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] == "weight" and (parts[-2] in _LINEARS
                                      or name == "lm_head.weight")


def _unroll(named: dict) -> dict:
    """Scan-model names -> unrolled names (per-block slices of the stacks);
    unrolled names pass through. Unknown names raise."""
    out = {}
    for name, arr in named.items():
        arr = np.asarray(arr)
        if name in _SCAN_BLOCK:
            for i in range(arr.shape[0]):
                out[f"gpt.blocks.{i}.{_SCAN_BLOCK[name]}"] = arr[i]
        elif name in _SCAN_TOP:
            out[_SCAN_TOP[name]] = arr
        elif _UNROLLED.match(name):
            out[name] = arr
        else:
            raise KeyError(f"params_from_paddle_tpu: unknown parameter "
                           f"{name!r}")
    return out


def params_from_paddle_tpu(named: dict) -> dict:
    """{reference name: numpy array} -> state_dict of the port's GPT
    (CPU tensors of the arrays' dtypes; Linear weights transposed)."""
    sd = {}
    for name, arr in _unroll(named).items():
        if _is_linear_weight(name):
            arr = arr.T
        sd[name] = torch.from_numpy(np.array(arr, order="C"))
    return sd
