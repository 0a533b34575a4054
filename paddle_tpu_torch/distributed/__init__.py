"""paddle_tpu_torch.distributed: what of paddle_tpu.distributed the
single-device trainer needs (recompute) and the serving fabric's
registry (`store`: TCPStore, ReplicatedStore, QuorumStore). Meshes,
ZeRO and collectives are ROADMAP queue 5."""
from .recompute import (recompute, recompute_sequential,  # noqa: F401
                        recompute_wrap_sublayers)
