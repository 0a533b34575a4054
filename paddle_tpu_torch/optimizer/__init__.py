"""paddle_tpu_torch.optimizer (counterpart of paddle_tpu/optimizer)."""
from . import lr  # noqa: F401
from .clip import (ClipGradByGlobalNorm, ClipGradByNorm,  # noqa: F401
                   ClipGradByValue)
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax,  # noqa: F401
                        AdamW, L1Decay, L2Decay, Lamb, Momentum, Optimizer,
                        RMSProp)
