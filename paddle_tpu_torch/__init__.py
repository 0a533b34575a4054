"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package `paddle_tpu` is the reference this package is held
against; nothing here imports it. Module names follow the reference so
each part can be found beside its counterpart. Plain tensor code is
PyTorch; every Pallas kernel of the reference on a ported path is a CUDA
kernel written for sm_90a (`ops/csrc/`).

Entry points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`, which the tests do; without a card they raise.
`seed(s)` reseeds the default key generator (core/rng.py), which
`GPTForCausalLM.generate(do_sample=True)` draws from.
"""
from __future__ import annotations

import torch

# Pin the reference's numerics (paddle_tpu/__init__.py sets
# jax_default_matmul_precision="highest"): f32 products stay true f32,
# speed comes from explicit bf16 dtypes, never from TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_device() -> torch.device:
    """The device an entry point uses when the caller names none: the
    first CUDA card. Raises when there is none, so no run carries on
    quietly on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: no CUDA device is available; pass "
            "device='cpu' explicitly to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    return default_device() if device is None else torch.device(device)


from .core.rng import seed  # noqa: E402,F401
