"""paddle_tpu_torch.hapi (counterpart of paddle_tpu.hapi): Model, its
callbacks, summary and flops."""
from .model import Model  # noqa: F401
from . import callbacks  # noqa: F401
from .summary import summary  # noqa: F401
from .flops import flops  # noqa: F401
