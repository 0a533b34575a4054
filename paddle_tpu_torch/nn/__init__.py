from . import functional  # noqa: F401
from .layers_common import (AlphaDropout, Dropout, Dropout2D,  # noqa: F401
                            Linear)
from .norm import LayerNorm  # noqa: F401
