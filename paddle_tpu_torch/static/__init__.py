"""paddle_tpu_torch.static (counterpart of paddle_tpu.static, cut to the
InputSpec that jit.save takes)."""
from __future__ import annotations

from ..jit import InputSpec  # noqa: F401

__all__ = ["InputSpec"]
