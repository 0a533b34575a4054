"""paddle_tpu_torch.inference.fabric — the cross-host serving fabric
(counterpart of paddle_tpu/inference/fabric), cut to its KV-handoff wire
format (`handoff`). The router, front door, membership, fleet, client
and host agent are ROADMAP queue 6."""
from . import handoff  # noqa: F401

__all__ = ["handoff"]
