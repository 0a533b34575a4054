"""paddle_tpu_torch.vision (counterpart of paddle_tpu.vision, cut to the
model re-exports)."""
from . import models  # noqa: F401
