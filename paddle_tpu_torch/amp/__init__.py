"""Mixed precision (counterpart of paddle_tpu/amp): O2 casts the model's
parameters to the AMP dtype; the optimizer keeps the f32 masters."""
from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def decorate(models, optimizers=None, level="O2", dtype="bfloat16"):
    """O2: cast every floating parameter of the model(s), LayerNorm's
    included, to `dtype`. Returns the model(s), and the optimizer(s) when
    given, as the reference does."""
    if dtype not in _DTYPES:
        raise ValueError(f"amp.decorate: unknown dtype {dtype!r}")
    if level not in ("O1", "O2"):
        raise ValueError(f"amp.decorate: unknown level {level!r}")
    dt = _DTYPES[dtype]
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        for m in model_list:
            for p in m.parameters():
                if p.is_floating_point():
                    p.data = p.data.to(dt)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers
