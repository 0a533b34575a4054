"""Runtime flags read by the ported path (counterpart of
paddle_tpu/core/flags.py, cut to the flags this package reads).

Each flag can be set from the environment as FLAGS_<name> when the module
is imported, and at run time with `set_flags`.
"""
from __future__ import annotations

import os
from typing import Any, Dict

_REGISTRY: Dict[str, Any] = {}


def define_flag(name: str, default):
    """Register a flag; env var FLAGS_<name> overrides the default."""
    val = default
    env = os.environ.get("FLAGS_" + name)
    if env is not None:
        if isinstance(default, bool):
            val = env.lower() in ("1", "true", "yes", "on")
        elif isinstance(default, int):
            val = int(env)
        elif isinstance(default, float):
            val = float(env)
        else:
            val = env
    _REGISTRY[name] = val
    return val


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _REGISTRY:
        raise KeyError(f"unknown flag {name}")
    return key


def set_flags(flags: Dict[str, Any]):
    # validate every key before changing any value
    resolved = {_key(n): v for n, v in flags.items()}
    _REGISTRY.update(resolved)
    # the tracer and the chaos harness latch their flags; re-arm them
    if resolved.keys() & {"trace_dir", "trace_buffer_spans"}:
        from ..observability import trace
        trace.reconfigure(_REGISTRY["trace_dir"])
    if resolved.keys() & {"chaos_spec", "chaos_seed"}:
        from ..testing import chaos
        chaos.configure()


def flag(name: str):
    return _REGISTRY[name]


# the train step's finiteness check of the loss and the f32-cast grads:
# a non-finite step raises FloatingPointError
define_flag("check_nan_inf", False)
# route attention to the flash kernels when the shape allows
define_flag("use_flash_attention", True)
# query-chunk size of the einsum attention at L >= 1024 when flash is not
# taken (each chunk's [B, H, chunk, L] scores recomputed in backward); 0
# takes the full einsum
define_flag("attention_chunk", 256)
# take the flash path even where the dot strategy alone would not: an
# auto-resolved "f32" below seq 2048 (see nn.functional's routing)
define_flag("force_flash_attention", False)
# the flash shape gate's query and key tiles: L must be a multiple of both
define_flag("flash_block_q", 128)
define_flag("flash_block_k", 128)
# dot strategy of the flash kernels: "bf16" (storage-dtype operands, the
# tensor cores), "nn" and "nn2" (the same function from pre-transposed K^T
# and V^T, and for nn2 also Q^T and dO^T in and dK^T and dV^T out), "f32"
# (every dot in f32, P and dS never rounded), "auto" (probe the card once
# and pick bf16 > nn > nn2 > f32; see ops.flash_attention.resolve_dot_impl)
define_flag("flash_dot_impl", "auto")

# the predict engine (inference/serving/engine.py): the most rows
# coalesced into one executed batch (batch buckets are pow2 up to it), how
# long the batcher holds a batch's first request open for batchmates, and
# the default per-request deadline (0: none; a request still queued past
# it fails 503)
define_flag("serving_max_batch_size", 8)
define_flag("serving_batch_timeout_ms", 2.0)
define_flag("serving_default_deadline_ms", 0.0)
# both serving engines: the queue depth beyond which requests are shed
# with 503 + Retry-After; generative serving (inference/serving/
# generate.py): the decode slots per worker and KV class (decode batch
# buckets are pow2 up to this), and the server-side cap on tokens per
# request (also its default)
define_flag("serving_max_queue_depth", 64)
define_flag("generate_slots", 8)
define_flag("generate_max_new_tokens", 128)
# deterministic fault injection (testing/chaos.py): ';'-separated rules
# 'site:action[:arg]'; empty disables all injection. The seed drives the
# probabilistic rules, so the same (spec, seed) fires the same faults
define_flag("chaos_spec", "")
define_flag("chaos_seed", 0)
# the train step's default for skip_bad_steps: a step whose loss or
# grads are non-finite leaves parameters and optimizer state as they were
# and is counted in TrainStep.bad_step_count instead of raising
define_flag("skip_nan_steps", False)
# span tracer (observability/trace.py): off unless a directory is set;
# the ring keeps at most this many spans
define_flag("trace_dir", "")
define_flag("trace_buffer_spans", 262144)
# TCPStore client ops (distributed/store.py): bounded retries, with
# exponential backoff and jitter capped by the op timeout, on transient
# connect and reset errors; 1 disables retry. add() never retries (a
# replay could double-count); the replicated and quorum stores' member
# clients pin 1, their own layer being the retry
define_flag("store_retry_attempts", 3)
# the metrics bus (observability/bus.py): per-step rows go to
# <dir>/metrics.jsonl and flush() writes <dir>/metrics.prom; empty keeps
# the series in memory only. Model.fit adds a TelemetryCallback when set
define_flag("metrics_dir", "")
# DataLoader(num_workers > 0): forked worker processes (numpy-only
# children, tensors made in the parent) instead of threads, for datasets
# whose samples hold no tensor
define_flag("dataloader_fork_workers", False)
# the profiler's MFU denominator in FLOP/s; 0 takes the card's bf16 dense
# peak from its name (profiler/stats/flops.py), 1e12 on the CPU
define_flag("device_peak_flops", 0.0)
