"""paddle_tpu_torch.inference.serving — the dynamic-batching predict
engine, continuous-batching generation on the card and their HTTP front
(counterpart of paddle_tpu/inference/serving):

    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import ServingEngine
    jit.save(model, prefix, input_spec=[jit.InputSpec([None, 512],
                                                      "int64")])
    eng = ServingEngine(prefix, max_batch_size=8, replicas=2)
    (logits,) = eng.predict([ids])

    from paddle_tpu_torch.inference import GenerativeEngine
    gen = GenerativeEngine(model, slots=8, max_context=1024)
    out = gen.generate(prompt_ids, max_new_tokens=64)["tokens"]
    out = gen.generate(prompt_ids, 64, temperature=0.8, top_k=50,
                       top_p=0.9, seed=42)["tokens"]
    srv = ServingHTTPServer(eng, generator=gen, port=8000).start()
    srv.stop()
"""
from .engine import ServingEngine  # noqa: F401
from .generate import (GenerateHandle, GenerativeEngine,  # noqa: F401
                       GenerativeMetrics, stack_gpt_params)
from .lifecycle import Future, ServingError  # noqa: F401
from .metrics import ServingMetrics, aggregate_snapshot  # noqa: F401
from .server import ServingHTTPServer  # noqa: F401

__all__ = ["ServingEngine", "ServingMetrics", "GenerativeEngine",
           "GenerateHandle", "GenerativeMetrics", "ServingError",
           "ServingHTTPServer", "Future", "stack_gpt_params",
           "aggregate_snapshot"]
