"""paddle_tpu_torch.regularizer (counterpart of paddle_tpu/regularizer.py)."""
from .optimizer.optimizer import L1Decay, L2Decay  # noqa: F401

__all__ = ["L1Decay", "L2Decay"]
