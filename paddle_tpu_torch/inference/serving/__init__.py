"""paddle_tpu_torch.inference.serving — continuous-batching generation
on the card (counterpart of paddle_tpu/inference/serving, cut to its
GenerativeEngine):

    from paddle_tpu_torch.inference import GenerativeEngine
    eng = GenerativeEngine(model, slots=8, max_context=1024)
    out = eng.generate(prompt_ids, max_new_tokens=64)["tokens"]
    out = eng.generate(prompt_ids, 64, temperature=0.8, top_k=50,
                       top_p=0.9, seed=42)["tokens"]
    eng.shutdown()
"""
from .generate import (GenerateHandle, GenerativeEngine,  # noqa: F401
                       GenerativeMetrics, stack_gpt_params)
from .lifecycle import Future, ServingError  # noqa: F401

__all__ = ["GenerativeEngine", "GenerateHandle", "GenerativeMetrics",
           "ServingError", "Future", "stack_gpt_params"]
