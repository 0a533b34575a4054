"""paddle_tpu_torch.inference.serving — continuous-batching generation
on the card and its HTTP front (counterpart of
paddle_tpu/inference/serving, cut to its GenerativeEngine and the
generation half of its server):

    from paddle_tpu_torch.inference import GenerativeEngine
    eng = GenerativeEngine(model, slots=8, max_context=1024)
    out = eng.generate(prompt_ids, max_new_tokens=64)["tokens"]
    out = eng.generate(prompt_ids, 64, temperature=0.8, top_k=50,
                       top_p=0.9, seed=42)["tokens"]
    srv = ServingHTTPServer(generator=eng, port=8000).start()
    srv.stop()
"""
from .generate import (GenerateHandle, GenerativeEngine,  # noqa: F401
                       GenerativeMetrics, stack_gpt_params)
from .lifecycle import Future, ServingError  # noqa: F401
from .server import ServingHTTPServer  # noqa: F401

__all__ = ["GenerativeEngine", "GenerateHandle", "GenerativeMetrics",
           "ServingError", "ServingHTTPServer", "Future",
           "stack_gpt_params"]
