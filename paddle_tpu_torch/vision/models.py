"""paddle.vision.models re-exports (counterpart of
paddle_tpu/vision/models.py, cut to the ResNet family; the reference's
vision_zoo waits)."""
from ..models.resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152)

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152"]
