"""paddle_tpu_torch.inference — serving (counterpart of
paddle_tpu/inference, cut to generation)."""
from .serving import (GenerateHandle, GenerativeEngine,  # noqa: F401
                      GenerativeMetrics, ServingError, stack_gpt_params)

__all__ = ["GenerativeEngine", "GenerateHandle", "GenerativeMetrics",
           "ServingError", "stack_gpt_params"]
