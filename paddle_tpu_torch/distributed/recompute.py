"""Activation recomputation (counterpart of
paddle_tpu/distributed/recompute.py).

`recompute(fn, *args)` runs `fn` under `torch.utils.checkpoint`
(non-reentrant): the forward keeps none of the segment's activations and
backward runs the segment again to rebuild them, the trade the reference
makes with `jax.checkpoint`. The replay draws the same dropout keys as
the first pass: the default generator's base key and counter are saved
at the segment's entry and put in place for the replay, then restored
(torch's own `preserve_rng_state` covers torch's generators, not the
port's). With grad disabled the segment just runs.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..core import rng as _rng


def recompute(function, *args, **kwargs):
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)     # always non-reentrant here
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    gen = _rng.default_generator()
    entry = gen.snapshot()
    replay = []

    def run(*a, **kw):
        if not replay:                    # the first pass
            replay.append(True)
            return function(*a, **kw)
        now = gen.snapshot()
        gen.restore(entry)
        try:
            return function(*a, **kw)
        finally:
            gen.restore(now)

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)


def recompute_wrap_sublayers(model, names=None):
    """Wrap sublayers' forward in `recompute`, in place. `names`: the
    sublayers' full names or last components (recompute_configs
    ["checkpoints"]); None wraps every sublayer whose last name component
    contains "block" or "layer", as the reference does."""
    for name, layer in list(model.named_modules()):
        if not name:
            continue
        leaf = name.split(".")[-1]
        match = (name in names or leaf in names) if names else \
            ("block" in leaf.lower() or "layer" in leaf.lower())
        if not match or getattr(layer, "_recompute_wrapped", False):
            continue
        orig = layer.forward
        layer.forward = (lambda f: lambda *a, **k: recompute(f, *a, **k))(
            orig)
        layer._recompute_wrapped = True
    return model


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Checkpoint a Sequential in `ctx["segments"]` segments."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    per = max(1, len(layers) // segments)
    out = args[0] if len(args) == 1 else args

    def run_chunk(chunk, x):
        for layer in chunk:
            x = layer(x)
        return x

    for i in range(0, len(layers), per):
        chunk = layers[i:i + per]
        out = recompute(lambda x, c=chunk: run_chunk(c, x), out)
    return out
