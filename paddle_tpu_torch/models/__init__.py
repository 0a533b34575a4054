from .bert import (BertConfig, BertEmbeddings, BertForMaskedLM,  # noqa: F401
                   BertModel)
from .gpt import GPTConfig, GPTForCausalLM, PRESETS  # noqa: F401
from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152)
