from . import functional  # noqa: F401
from .container import LayerList, Sequential  # noqa: F401
from .conv_pool import (AdaptiveAvgPool2D, AvgPool2D, Conv2D,  # noqa: F401
                        MaxPool2D)
from .layers_common import (GELU, AlphaDropout, Dropout,  # noqa: F401
                            Dropout2D, Embedding, Flatten, Identity, Linear,
                            ReLU, Tanh)
from .loss import CrossEntropyLoss  # noqa: F401
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D, LayerNorm)
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
