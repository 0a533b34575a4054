"""paddle_tpu_torch.callbacks (counterpart of paddle_tpu/callbacks.py):
the hapi callbacks."""
from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProfilerCallback,
    ProgBarLogger, ReduceLROnPlateau, TelemetryCallback)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "LRScheduler",
           "EarlyStopping", "ReduceLROnPlateau", "ProfilerCallback",
           "TelemetryCallback"]
