"""paddle_tpu_torch.inference — serving (counterpart of
paddle_tpu/inference, cut to generation, its HTTP front and the KV
handoff's wire format)."""
from .serving import (GenerateHandle, GenerativeEngine,  # noqa: F401
                      GenerativeMetrics, ServingError, ServingHTTPServer,
                      stack_gpt_params)

__all__ = ["GenerativeEngine", "GenerateHandle", "GenerativeMetrics",
           "ServingError", "ServingHTTPServer", "stack_gpt_params"]
