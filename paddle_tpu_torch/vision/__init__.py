"""paddle_tpu_torch.vision (counterpart of paddle_tpu.vision, cut to the
ResNet models, FakeData and the transforms)."""
from . import datasets, models, transforms  # noqa: F401
